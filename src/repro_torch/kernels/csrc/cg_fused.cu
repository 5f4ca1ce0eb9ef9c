// Fused conjugate-gradient vector updates of the NLINV inner solver, for
// Hopper (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into
// one shared library and bound with ctypes: plain C entry points, no
// PyTorch headers.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cg_fused/kernel.py:
//   cg_update_pallas   x' = x + alpha*p,  r' = r - alpha*Ap,  rs = sum |r'|^2
//   xpby_pallas        w  = x + beta*y
// over complex64 operands of any shape (flattened to n complex values),
// with alpha and beta real float32 scalars that stay on the device.
//
// What bounds them on the H100: bytes.  cg_update does 12 flops per
// complex element while moving 48 bytes of it (four reads, two writes);
// xpby 4 flops per 24 bytes.  Both are two orders of magnitude below the
// card's float32 line, so the least time is the device-memory traffic.
//
// What the design does about it: one pass over the operands.  The x and r
// updates and the rs epilogue share one read of p, Ap, x and r, where the
// unfused body pays three passes (two axpys and a dot).  alpha and beta
// are read through device pointers, so the host never waits for them: the
// solver's only host sync per iteration is its stop test.  The rs sum is
// deterministic, with no float atomics: each block reduces its grid-stride
// share in a fixed tree (warp shuffles, then the block's warp sums) into
// a per-block partial, and a second one-block launch sums the partials in
// a fixed order.  The number of blocks depends only on n and the scratch
// capacity, so the same inputs give the same bits on every run, which the
// JAX package's batched == sequential and quarantine guarantees rely on.
//
// Each entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not 0.  Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // the block reduction assumes this width
constexpr long long kMaxBlocks = 65535;

inline unsigned blocks_for(long long n, long long cap) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > cap) b = cap;
  return static_cast<unsigned>(b);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// Sum of v over the block, in a fixed order; the result is valid in
// thread 0.  Requires blockDim.x == kThreads.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
  }
  return v;
}

__global__ void cg_update_kernel(const float* __restrict__ alpha,
                                 const float2* __restrict__ p,
                                 const float2* __restrict__ ap,
                                 const float2* __restrict__ x,
                                 const float2* __restrict__ r,
                                 float2* __restrict__ x_out,
                                 float2* __restrict__ r_out,
                                 float* __restrict__ partials, long long n) {
  const float a = *alpha;
  float acc = 0.0f;
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const float2 pv = p[i];
    const float2 apv = ap[i];
    const float2 xv = x[i];
    const float2 rv = r[i];
    x_out[i] = make_float2(xv.x + a * pv.x, xv.y + a * pv.y);
    const float2 r2 = make_float2(rv.x - a * apv.x, rv.y - a * apv.y);
    r_out[i] = r2;
    acc += r2.x * r2.x + r2.y * r2.y;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int nparts, float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

__global__ void xpby_kernel(const float* __restrict__ beta,
                            const float2* __restrict__ x,
                            const float2* __restrict__ y,
                            float2* __restrict__ w, long long n) {
  const float b = *beta;
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const float2 xv = x[i];
    const float2 yv = y[i];
    w[i] = make_float2(xv.x + b * yv.x, xv.y + b * yv.y);
  }
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// partials: scratch of `capacity` floats; rs: one float.
int cg_update(const void* alpha, const void* p, const void* ap, const void* x,
              const void* r, void* x_out, void* r_out, void* partials,
              long long capacity, void* rs, long long n, void* stream) {
  const long long cap = capacity < kMaxBlocks ? capacity : kMaxBlocks;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nblk = blocks_for(n, cap);
  cg_update_kernel<<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float2*>(p),
      static_cast<const float2*>(ap), static_cast<const float2*>(x),
      static_cast<const float2*>(r), static_cast<float2*>(x_out),
      static_cast<float2*>(r_out), static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(partials), static_cast<int>(nblk),
      static_cast<float*>(rs));
  return static_cast<int>(cudaGetLastError());
}

int xpby(const void* beta, const void* x, const void* y, void* w, long long n,
         void* stream) {
  xpby_kernel<<<blocks_for(n, kMaxBlocks), kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(beta), static_cast<const float2*>(x),
      static_cast<const float2*>(y), static_cast<float2*>(w), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
