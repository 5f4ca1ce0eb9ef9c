// Fused conjugate-gradient vector updates of the NLINV inner solver, for
// Hopper (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into
// one shared library and bound with ctypes: plain C entry points, no
// PyTorch headers.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cg_fused/kernel.py:
//   cg_update_pallas   x' = x + alpha*p,  r' = r - alpha*Ap,  rs = sum |r'|^2
//   xpby_pallas        w  = x + beta*y
//   xpby_dot_pallas    w  = x + beta*y,  d = sum |w|^2
// over complex64 operands of any shape (flattened to n complex values),
// with alpha and beta real float32 scalars that stay on the device.
//
// What bounds them on the H100: bytes.  cg_update does 12 flops per
// complex element while moving 48 bytes of it (four reads, two writes);
// xpby 4 flops per 24 bytes, xpby_dot 8 per 24.  Both are two orders of magnitude below the
// card's float32 line, so the least time is the device-memory traffic.
//
// What the design does about it: one pass over the operands.  The x and r
// updates and the rs epilogue share one read of p, Ap, x and r, where the
// unfused body pays three passes (two axpys and a dot); xpby_dot's d
// rides its one pass over x and y the same way.  alpha and beta
// are read through device pointers, so the host never waits for them: the
// solver's only host sync per iteration is its stop test.  The rs and d
// sums are deterministic, with no float atomics: each block reduces its grid-stride
// share in a fixed tree (warp shuffles, then the block's warp sums) into
// a per-block partial, and a second one-block launch sums the partials in
// a fixed order.  The number of blocks depends only on n and the scratch
// capacity, so the same inputs give the same bits on every run, which the
// JAX package's batched == sequential and quarantine guarantees rely on.
//
// cg_update and xpby take a leading batch of B independent rows (the
// serving layer's clients, each with its own CG state): the grid's second
// dimension (blockIdx.y) is the row, alpha and beta are (B,) device
// vectors, and rs is (B,).  Each row's partial sums take `capacity` slots
// of the scratch and exactly the blocks and the fixed order of the
// unbatched call over that row's n, so a row's bits depend neither on B
// nor on the other rows, and at B = 1 the kernels are the unbatched ones.
// An optional (B,) active mask (one byte a row) freezes the rows whose CG
// loop has stopped: a block of an inactive row writes its outputs as
// copies of its inputs (x' = x and r' = r, rs of that r; xpby's w = y, the
// frozen search direction), whatever alpha or beta hold, so a row whose
// alpha is NaN keeps its x, as the JAX package's vmapped while loop keeps
// a stopped row's state.
//
// Each entry returns cudaGetLastError() after its launches; the Python
// wrapper raises when it is not 0.  Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // the block reduction assumes this width
constexpr long long kMaxBlocks = 65535;

constexpr long long kMaxBatch = 65535;  // the grid's second dimension

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

// This block's batch row, and whether its CG loop still runs (a null mask:
// every row does).
__device__ __forceinline__ long long row() {
  return static_cast<long long>(blockIdx.y);
}

__device__ __forceinline__ bool row_active(const unsigned char* active) {
  return active == nullptr || active[blockIdx.y] != 0;
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
                                 const unsigned char* __restrict__ active,
                                 const float2* __restrict__ p,
                                 const float2* __restrict__ ap,
                                 const float2* __restrict__ x,
                                 const float2* __restrict__ r,
                                 float2* __restrict__ x_out,
                                 float2* __restrict__ r_out,
                                 float* __restrict__ partials,
                                 long long capacity, long long n) {
  const long long off = row() * n;
  p += off;
  ap += off;
  x += off;
  r += off;
  x_out += off;
  r_out += off;
  float acc = 0.0f;
  if (row_active(active)) {
    const float a = alpha[blockIdx.y];
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
  } else {
    for (long long i = first_index(); i < n; i += grid_stride()) {
      const float2 rv = r[i];
      x_out[i] = x[i];
      r_out[i] = rv;
      acc += rv.x * rv.x + rv.y * rv.y;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[row() * capacity + blockIdx.x] = acc;
}

// out[b] = the sum of row b's first nparts partials, in a fixed order: one
// block a row.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int nparts, long long capacity,
                                    float* __restrict__ out) {
  partials += static_cast<long long>(blockIdx.x) * capacity;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

__global__ void xpby_kernel(const float* __restrict__ beta,
                            const unsigned char* __restrict__ active,
                            const float2* __restrict__ x,
                            const float2* __restrict__ y,
                            float2* __restrict__ w, long long n) {
  const long long off = row() * n;
  x += off;
  y += off;
  w += off;
  if (!row_active(active)) {
    for (long long i = first_index(); i < n; i += grid_stride()) w[i] = y[i];
    return;
  }
  const float b = beta[blockIdx.y];
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const float2 xv = x[i];
    const float2 yv = y[i];
    w[i] = make_float2(xv.x + b * yv.x, xv.y + b * yv.y);
  }
}

__global__ void xpby_dot_kernel(const float* __restrict__ beta,
                                const float2* __restrict__ x,
                                const float2* __restrict__ y,
                                float2* __restrict__ w,
                                float* __restrict__ partials, long long n) {
  const float b = *beta;
  float acc = 0.0f;
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const float2 xv = x[i];
    const float2 yv = y[i];
    const float2 wv = make_float2(xv.x + b * yv.x, xv.y + b * yv.y);
    w[i] = wv;
    acc += wv.x * wv.x + wv.y * wv.y;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// alpha: (B,) floats; active: (B,) bytes or null; partials: scratch of
// B * capacity floats; rs: (B,) floats; n: complex values a row.
int cg_update(const void* alpha, const void* active, const void* p,
              const void* ap, const void* x, const void* r, void* x_out,
              void* r_out, void* partials, long long capacity, void* rs,
              long long n, long long batch, void* stream) {
  const long long cap = capacity < kMaxBlocks ? capacity : kMaxBlocks;
  if (cap < 1 || batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nblk = blocks_for(n, cap);
  cg_update_kernel<<<dim3(nblk, static_cast<unsigned>(batch)), kThreads, 0,
                     as_stream(stream)>>>(
      static_cast<const float*>(alpha),
      static_cast<const unsigned char*>(active),
      static_cast<const float2*>(p), static_cast<const float2*>(ap),
      static_cast<const float2*>(x), static_cast<const float2*>(r),
      static_cast<float2*>(x_out), static_cast<float2*>(r_out),
      static_cast<float*>(partials), capacity, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<static_cast<unsigned>(batch), kThreads, 0,
                        as_stream(stream)>>>(
      static_cast<const float*>(partials), static_cast<int>(nblk), capacity,
      static_cast<float*>(rs));
  return static_cast<int>(cudaGetLastError());
}

// partials: scratch of `capacity` floats; d: one float.
int xpby_dot(const void* beta, const void* x, const void* y, void* w,
             void* partials, long long capacity, void* d, long long n,
             void* stream) {
  const long long cap = capacity < kMaxBlocks ? capacity : kMaxBlocks;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nblk = blocks_for(n, cap);
  xpby_dot_kernel<<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(beta), static_cast<const float2*>(x),
      static_cast<const float2*>(y), static_cast<float2*>(w),
      static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(partials), static_cast<int>(nblk), capacity,
      static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

// beta: (B,) floats; active: (B,) bytes or null; n: complex values a row.
int xpby(const void* beta, const void* active, const void* x, const void* y,
         void* w, long long n, long long batch, void* stream) {
  if (batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  xpby_kernel<<<dim3(blocks_for(n, kMaxBlocks), static_cast<unsigned>(batch)),
                kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(beta),
      static_cast<const unsigned char*>(active),
      static_cast<const float2*>(x), static_cast<const float2*>(y),
      static_cast<float2*>(w), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
