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
// sums are deterministic, with no float atomics: each partial sums a
// fixed tile of the elements in a fixed tree (warp shuffles, then the
// tile's warp sums), and a second one-block launch sums the partials in a
// fixed order.  The tiles depend only on n and the scratch capacity, not
// on the launch shape (kLanes below), so the same inputs give the same
// bits on every run and under every block, which the JAX package's
// batched == sequential and quarantine guarantees rely on.
//
// cg_update and xpby take a leading batch of B independent rows (the
// serving layer's clients, each with its own CG state): the grid's second
// dimension (blockIdx.y) is the row, alpha and beta are (B,) device
// vectors, and rs is (B,).  Each row's partial sums take `capacity` slots
// of the scratch and exactly the tiles and the fixed order of the
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

// A partial sum covers a fixed tile: kLanes lanes, lane l of partial p
// adding elements p * kLanes + l + k * nparts * kLanes, k = 0, 1, ... in
// order, then a fixed tree over the lanes (warp shuffles, then the eight
// warp sums).  nparts depends on n and the scratch capacity alone, so the
// partials, their order and the final sum do not depend on the threads a
// block has: a block of 128 threads gives each thread two lanes of one
// partial, one of 256 a lane each, one of 512 two partials.  Every block
// shape gives the same bits; 256 threads is the shape these kernels had as
// a constant, and the default.
constexpr int kLanes = 256;
constexpr int kLaneWarps = kLanes / 32;
constexpr int kMaxThreads = 512;
constexpr int kSumThreads = 256;  // sum_partials_kernel's block
constexpr long long kMaxBlocks = 65535;

constexpr long long kMaxBatch = 65535;  // the grid's second dimension

inline bool valid_threads(int threads) {
  return threads == 128 || threads == 256 || threads == 512;
}

// Partial sums of n elements: one a tile of kLanes, at most cap.
inline long long parts_for(long long n, long long cap) {
  long long b = (n + kLanes - 1) / kLanes;
  if (b < 1) b = 1;
  return b > cap ? cap : b;
}

// Blocks of `threads` that hold nparts partials.
inline unsigned blocks_for_parts(long long nparts, int threads) {
  const long long per = threads >= kLanes ? threads / kLanes : 1;
  return static_cast<unsigned>((nparts + per - 1) / per);
}

inline unsigned blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
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

// Sum over a warp by shuffles, valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of v over a block of kSumThreads, in a fixed order; the result is
// valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kSumThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < kSumThreads / 32 ? warp_sums[lane] : 0.0f);
  }
  return v;
}

// This thread's share of the tiles: `nlanes` (1 or 2) lanes of partial
// `part`.
struct Share {
  long long part;
  int lane[2];
  int nlanes;
};

__device__ __forceinline__ Share share_of() {
  Share s;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  if (nt >= kLanes) {
    s.part = static_cast<long long>(blockIdx.x) * (nt / kLanes) + t / kLanes;
    s.lane[0] = t % kLanes;
    s.lane[1] = 0;
    s.nlanes = 1;
  } else {
    s.part = blockIdx.x;
    s.lane[0] = t;
    s.lane[1] = t + nt;
    s.nlanes = kLanes / nt;
  }
  return s;
}

// The block's partials from its lanes' sums acc[v] (lane sh.lane[v]): each
// lane's warp sum, then the eight warp sums of a tile, in the one fixed
// tree.  Every thread of the block must call it.
__device__ __forceinline__ void write_partials(const Share& sh,
                                               const float* acc,
                                               float* __restrict__ out,
                                               long long nparts) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    if (v < sh.nlanes) {
      const float w = warp_sum(acc[v]);
      const int at = blockDim.x >= kLanes ? threadIdx.x : sh.lane[v];
      if (lane == 0) warp_sums[at / 32] = w;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int per = blockDim.x >= kLanes ? blockDim.x / kLanes : 1;
  if (warp < per) {
    const float w = warp_sum(lane < kLaneWarps
                                 ? warp_sums[warp * kLaneWarps + lane]
                                 : 0.0f);
    const long long part = static_cast<long long>(blockIdx.x) * per + warp;
    if (lane == 0 && part < nparts) out[part] = w;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
cg_update_kernel(const float* __restrict__ alpha,
                 const unsigned char* __restrict__ active,
                 const float2* __restrict__ p,
                 const float2* __restrict__ ap,
                 const float2* __restrict__ x,
                 const float2* __restrict__ r,
                 float2* __restrict__ x_out, float2* __restrict__ r_out,
                 float* __restrict__ partials, long long capacity,
                 long long nparts, long long n) {
  const long long off = row() * n;
  p += off;
  ap += off;
  x += off;
  r += off;
  x_out += off;
  r_out += off;
  const Share sh = share_of();
  float acc[2] = {0.0f, 0.0f};
  if (sh.part < nparts) {
    const long long step = nparts * kLanes;
    const bool live = row_active(active);
    const float a = live ? alpha[blockIdx.y] : 0.0f;
    for (long long base = sh.part * kLanes; base < n; base += step) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const long long i = base + sh.lane[v];
        if (v >= sh.nlanes || i >= n) continue;
        const float2 rv = r[i];
        if (live) {
          const float2 pv = p[i];
          const float2 apv = ap[i];
          const float2 xv = x[i];
          x_out[i] = make_float2(xv.x + a * pv.x, xv.y + a * pv.y);
          const float2 r2 = make_float2(rv.x - a * apv.x, rv.y - a * apv.y);
          r_out[i] = r2;
          acc[v] += r2.x * r2.x + r2.y * r2.y;
        } else {
          x_out[i] = x[i];
          r_out[i] = rv;
          acc[v] += rv.x * rv.x + rv.y * rv.y;
        }
      }
    }
  }
  write_partials(sh, acc, partials + row() * capacity, nparts);
}

// out[b] = the sum of row b's first nparts partials, in a fixed order: one
// block of kSumThreads a row.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int nparts, long long capacity,
                                    float* __restrict__ out) {
  partials += static_cast<long long>(blockIdx.x) * capacity;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kSumThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kMaxThreads)
xpby_kernel(const float* __restrict__ beta,
            const unsigned char* __restrict__ active,
            const float2* __restrict__ x, const float2* __restrict__ y,
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

__global__ void __launch_bounds__(kMaxThreads)
xpby_dot_kernel(const float* __restrict__ beta,
                const float2* __restrict__ x, const float2* __restrict__ y,
                float2* __restrict__ w, float* __restrict__ partials,
                long long nparts, long long n) {
  const float b = *beta;
  const Share sh = share_of();
  float acc[2] = {0.0f, 0.0f};
  if (sh.part < nparts) {
    const long long step = nparts * kLanes;
    for (long long base = sh.part * kLanes; base < n; base += step) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const long long i = base + sh.lane[v];
        if (v >= sh.nlanes || i >= n) continue;
        const float2 xv = x[i];
        const float2 yv = y[i];
        const float2 wv = make_float2(xv.x + b * yv.x, xv.y + b * yv.y);
        w[i] = wv;
        acc[v] += wv.x * wv.x + wv.y * wv.y;
      }
    }
  }
  write_partials(sh, acc, partials, nparts);
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// The last argument before the stream is the block: threads per block,
// 128, 256 or 512.

// alpha: (B,) floats; active: (B,) bytes or null; partials: scratch of
// B * capacity floats; rs: (B,) floats; n: complex values a row.
int cg_update(const void* alpha, const void* active, const void* p,
              const void* ap, const void* x, const void* r, void* x_out,
              void* r_out, void* partials, long long capacity, void* rs,
              long long n, long long batch, int threads, void* stream) {
  const long long cap = capacity < kMaxBlocks ? capacity : kMaxBlocks;
  if (cap < 1 || batch < 1 || batch > kMaxBatch || !valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nparts = parts_for(n, cap);
  cg_update_kernel<<<dim3(blocks_for_parts(nparts, threads),
                          static_cast<unsigned>(batch)),
                     threads, 0, as_stream(stream)>>>(
      static_cast<const float*>(alpha),
      static_cast<const unsigned char*>(active),
      static_cast<const float2*>(p), static_cast<const float2*>(ap),
      static_cast<const float2*>(x), static_cast<const float2*>(r),
      static_cast<float2*>(x_out), static_cast<float2*>(r_out),
      static_cast<float*>(partials), capacity, nparts, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<static_cast<unsigned>(batch), kSumThreads, 0,
                        as_stream(stream)>>>(
      static_cast<const float*>(partials), static_cast<int>(nparts),
      capacity, static_cast<float*>(rs));
  return static_cast<int>(cudaGetLastError());
}

// partials: scratch of `capacity` floats; d: one float.
int xpby_dot(const void* beta, const void* x, const void* y, void* w,
             void* partials, long long capacity, void* d, long long n,
             int threads, void* stream) {
  const long long cap = capacity < kMaxBlocks ? capacity : kMaxBlocks;
  if (cap < 1 || !valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nparts = parts_for(n, cap);
  xpby_dot_kernel<<<blocks_for_parts(nparts, threads), threads, 0,
                    as_stream(stream)>>>(
      static_cast<const float*>(beta), static_cast<const float2*>(x),
      static_cast<const float2*>(y), static_cast<float2*>(w),
      static_cast<float*>(partials), nparts, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kSumThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(partials), static_cast<int>(nparts),
      capacity, static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

// beta: (B,) floats; active: (B,) bytes or null; n: complex values a row.
int xpby(const void* beta, const void* active, const void* x, const void* y,
         void* w, long long n, long long batch, int threads, void* stream) {
  if (batch < 1 || batch > kMaxBatch || !valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  xpby_kernel<<<dim3(blocks_for(n, threads), static_cast<unsigned>(batch)),
                threads, 0, as_stream(stream)>>>(
      static_cast<const float*>(beta),
      static_cast<const unsigned char*>(active),
      static_cast<const float2*>(x), static_cast<const float2*>(y),
      static_cast<float2*>(w), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
