// Radial gridding and degridding (bilinear interpolation on the periodic
// k-space grid) for Hopper (sm_90a).  Built by repro_torch/kernels/_build.py
// with nvcc into one shared library and bound with ctypes: plain C entry
// points, no PyTorch headers.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gridding/kernel.py:
//   degrid_pallas   out[j, s] = sum_v (Ax g_j)[s, v] * Ay[s, v]
//   grid_pallas     g_j = Ax^T (y_j[:, None] * Ay)      (the exact adjoint)
// The TPU form multiplies dense separable matrices Ax (Sp, X) and
// Ay (Sp, Y), two nonzeros per row, because a TPU has no atomics and its
// matrix unit wants dense tiles.  Here the same operator is read in the
// compact form the gridding plan keeps on the card:
//   taps    idx (Sp, 4) int32 = (ix0, ix1, iy0, iy1),
//           w   (Sp, 4) f32   = (wx0, wx1, wy0, wy1), i.e. the two
//           nonzero columns and values of row s of Ax and of Ay;
//   cells   a cell-major index (CSR) of the adjoint: for grid cell
//           c = u * grid + v, entries ptr[c] .. ptr[c+1] - 1, each a
//           sample s and its weights (Ax[s, u], Ay[s, v]), in the fixed
//           order of a stable sort on (cell, sample, corner).
// Complex data is PyTorch's interleaved complex64 (float2): g (J, X, Y),
// samples (J, Sp).
//
// What bounds them on the H100: bytes.  degrid does 18 flops per sample
// and coil against 32 bytes gathered; grid_adjoint 6 flops per entry and
// coil, and must write the whole (J, X, Y) grid.  Both sit two orders of
// magnitude below the card's float32 line.  At the main path's width
// (J = 8, grid 768, 16896 samples) the dense pair alone would be 103.8 MB
// of reads, the gather form moves a few MB for degrid and the 37.7 MB
// output grid plus about 3.5 MB of index and samples for grid_adjoint.
//
// What the design does about it:
// - degrid: one thread per sample reads its taps once (one 16-byte load
//   each for indices and weights) and loops over the J coils, gathering
//   the four cells of each coil's plane.  Neighbouring threads take
//   neighbouring samples, so each coil's writes are coalesced, and the
//   gathers of neighbouring samples along a spoke hit the same cache
//   lines.  Padded rows (s >= S) write 0.
// - grid_adjoint: a gather too, with no atomics.  One thread per output
//   cell walks the cell's entries in the index's fixed order and keeps the
//   sums of up to kCoilBlock coils in registers (more coils take another
//   walk over the same entries), computing wx * (y_j[s] * wy) as
//   Ax^T (y * Ay) does.  Every output cell is written exactly once, with
//   zeros where no sample falls, in coalesced rows of each coil's plane.
//   The order of every sum is fixed by the index, so the result repeats
//   bit for bit; samples of padded rows are never read.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kDegridThreads = 128;
constexpr int kGridThreads = 256;
constexpr int kCoilBlock = 8;

inline unsigned blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// t = wa * a + wb * b for complex a, b and real weights.
__device__ __forceinline__ float2 lerp2(float wa, float2 a, float wb,
                                        float2 b) {
  return make_float2(wa * a.x + wb * b.x, wa * a.y + wb * b.y);
}

__global__ void degrid_kernel(const float2* __restrict__ g,
                              const int4* __restrict__ idx,
                              const float4* __restrict__ w,
                              float2* __restrict__ out, long long ncoils,
                              long long grid, long long nsamp,
                              long long nsamp_padded) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nsamp_padded) return;
  if (s >= nsamp) {
    for (long long j = 0; j < ncoils; ++j) {
      out[j * nsamp_padded + s] = make_float2(0.0f, 0.0f);
    }
    return;
  }
  const int4 c = idx[s];
  const float4 wt = w[s];
  const long long plane = grid * grid;
  const long long x0 = c.x * grid, x1 = c.y * grid;
  for (long long j = 0; j < ncoils; ++j) {
    const float2* gj = g + j * plane;
    // (Ax g_j)[s, v] at the two columns v = iy0, iy1, then the Ay row
    const float2 t0 = lerp2(wt.x, gj[x0 + c.z], wt.y, gj[x1 + c.z]);
    const float2 t1 = lerp2(wt.x, gj[x0 + c.w], wt.y, gj[x1 + c.w]);
    out[j * nsamp_padded + s] = lerp2(wt.z, t0, wt.w, t1);
  }
}

__global__ void grid_adjoint_kernel(const float2* __restrict__ y,
                                    const int* __restrict__ cell_ptr,
                                    const int* __restrict__ cell_samp,
                                    const float2* __restrict__ cell_w,
                                    float2* __restrict__ out,
                                    long long ncoils, long long ncells,
                                    long long nsamp_padded) {
  const long long c =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= ncells) return;
  const int e0 = cell_ptr[c];
  const int e1 = cell_ptr[c + 1];
  for (long long j0 = 0; j0 < ncoils; j0 += kCoilBlock) {
    const int nj = static_cast<int>(
        ncoils - j0 < kCoilBlock ? ncoils - j0 : kCoilBlock);
    float2 acc[kCoilBlock];
#pragma unroll
    for (int jj = 0; jj < kCoilBlock; ++jj) acc[jj] = make_float2(0.f, 0.f);
    for (int e = e0; e < e1; ++e) {
      const long long s = cell_samp[e];
      const float2 wv = cell_w[e];  // (wx, wy)
#pragma unroll
      for (int jj = 0; jj < kCoilBlock; ++jj) {
        if (jj < nj) {
          const float2 v = y[(j0 + jj) * nsamp_padded + s];
          const float pr = v.x * wv.y;
          const float pi = v.y * wv.y;
          acc[jj].x += wv.x * pr;
          acc[jj].y += wv.x * pi;
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCoilBlock; ++jj) {
      if (jj < nj) out[(j0 + jj) * ncells + c] = acc[jj];
    }
  }
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// g: (ncoils, grid, grid) complex64; idx/w: (nsamp_padded, 4) taps;
// out: (ncoils, nsamp_padded) complex64.
int degrid(const void* g, const void* idx, const void* w, void* out,
           long long ncoils, long long grid, long long nsamp,
           long long nsamp_padded, void* stream) {
  degrid_kernel<<<blocks_for(nsamp_padded, kDegridThreads), kDegridThreads,
                  0, as_stream(stream)>>>(
      static_cast<const float2*>(g), static_cast<const int4*>(idx),
      static_cast<const float4*>(w), static_cast<float2*>(out), ncoils, grid,
      nsamp, nsamp_padded);
  return static_cast<int>(cudaGetLastError());
}

// y: (ncoils, nsamp_padded) complex64; cell_ptr: (grid*grid + 1,) int32;
// cell_samp: (nnz,) int32; cell_w: (nnz, 2) f32;
// out: (ncoils, grid, grid) complex64.
int grid_adjoint(const void* y, const void* cell_ptr, const void* cell_samp,
                 const void* cell_w, void* out, long long ncoils,
                 long long grid, long long nsamp_padded, void* stream) {
  const long long ncells = grid * grid;
  grid_adjoint_kernel<<<blocks_for(ncells, kGridThreads), kGridThreads, 0,
                        as_stream(stream)>>>(
      static_cast<const float2*>(y), static_cast<const int*>(cell_ptr),
      static_cast<const int*>(cell_samp), static_cast<const float2*>(cell_w),
      static_cast<float2*>(out), ncoils, ncells, nsamp_padded);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
