// Masked G-way sum of partial images, the local half of the paper's
// kern_all_red_p2p_2d, for Hopper (sm_90a).  Built by
// repro_torch/kernels/_build.py with nvcc into one shared library and bound
// with ctypes: a plain C entry point, no PyTorch headers.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/masked_allreduce/kernel.py:
//   masked_sum_pallas   out = m * sum_g partial_g
// over a (G, X, Y) complex64 stack and a float32 (X, Y) mask, or over a
// (G, B, X, Y) stack of B rows (the batched NLINV frame's clients) with
// the one (X, Y) mask shared by the rows.  In the distributed NLINV frame
// each rank all-gathers the ranks' FOV windows of the channel sum (G = 4
// at the main path's 384 x 384 window; the serving layer's B rows in the
// same all-gather) and sums them with this kernel, so the G partials are
// read once and the mask is applied in the same pass.
//
// What bounds it on the H100: bytes.  2G flops per element against
// (G + 1) * 8 + 4 bytes, far below the float32 line.
//
// What the design does about it: one pass, one thread per output element
// (B * X * Y of them), each reading the G partials of its element
// (neighbouring threads on neighbouring addresses of each plane) and the
// mask once.  The G partials are summed in order g = 0 .. G-1, with no
// atomics and no cross-thread reduction, so the same stack gives the same
// bits on every run and on every rank, and a row of a batched launch the
// bits of the unbatched launch on that row.  The stack's plane, row-batch
// and row strides and the output's batch and row strides are arguments,
// so the kernel reads a window of a larger image or a gathered payload
// (extras after each plane) in place and writes straight into a window of
// a zero-filled image: no packing copies around it.
//
// The launch shape, threads per block, is the caller's (the spec's block,
// chosen by the registry's autotuner when a plan is built; 256, the
// default, is the constant it had).  A thread's element and its order of
// summation do not depend on it, so every block gives the same bits.
//
// The entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  The launch goes on the caller's
// stream.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr long long kMaxBlocks = 65535;

__global__ void __launch_bounds__(kMaxThreads)
masked_sum_kernel(const float2* __restrict__ partials,
                                  long long plane_stride,
                                  long long batch_stride,
                                  long long row_stride,
                                  const float* __restrict__ mask,
                                  float2* __restrict__ out,
                                  long long out_batch_stride,
                                  long long out_row_stride, int nparts,
                                  long long nbatch, long long rows,
                                  long long cols) {
  const long long per = rows * cols;
  const long long n = nbatch * per;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const long long b = i / per;
    const long long e = i - b * per;
    const long long r = e / cols;
    const long long c = e - r * cols;
    const float2* src = partials + b * batch_stride + r * row_stride + c;
    float re = 0.0f;
    float im = 0.0f;
    for (int g = 0; g < nparts; ++g) {
      const float2 v = src[g * plane_stride];
      re += v.x;
      im += v.y;
    }
    const float m = mask[e];
    out[b * out_batch_stride + r * out_row_stride + c] =
        make_float2(re * m, im * m);
  }
}

}  // namespace

extern "C" {

// Strides count complex elements.  mask is a contiguous (rows, cols)
// plane; an unbatched call passes nbatch = 1.  threads: a multiple of 32
// up to 512.
int masked_sum(const void* partials, long long plane_stride,
               long long batch_stride, long long row_stride,
               const void* mask, void* out, long long out_batch_stride,
               long long out_row_stride, int nparts, long long nbatch,
               long long rows, long long cols, int threads, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (nbatch * rows * cols + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  masked_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(partials), plane_stride, batch_stride,
      row_stride, static_cast<const float*>(mask), static_cast<float2*>(out),
      out_batch_stride, out_row_stride, nparts, nbatch, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
