// The RG-LRU linear recurrence of the recurrentgemma prefill, for Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into one
// shared library and bound with ctypes: plain C entry points, no PyTorch
// headers.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rg_lru/kernel.py,
// rg_lru_pallas:
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0
// over log_a, b (B, S, W) and h0 (B, W), float32 or bfloat16, returning
// every h_t (B, S, W) and h_last (B, W) in the inputs' type.  The carried
// state stays in float32 from h0 to h_last, as the TPU kernel keeps it in
// VMEM scratch.
//
// What bounds it on the H100: bytes.  Three flops per element (exp, mul,
// add) against 12 bytes in float32 (two reads, one write): at the path's
// shape (S = 3072, W = 2560) 94.4 MB, 0.028 ms at 3.35 TB/s.
//
// What the design does about it, in this first form: one pass over the
// data, like the TPU kernel.  One thread per (batch, width) lane walks
// time in order with the state in a register; a warp reads 32 neighbouring
// lanes of one time step, so every load and store is coalesced.  Each
// thread loads 16 steps of log_a and b before it computes them, so the
// loads of a chunk are in flight together.  Blocks are one warp, to spread
// the lanes over as many SMs as they fill: at W = 2560 that is 80 of the
// 132, and the scan is latency-bound rather than bandwidth-bound.  A
// chunked two-level scan, which would fill the card, is later work.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  The launch goes on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 16;

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
              const T* __restrict__ h0, T* __restrict__ hs,
              T* __restrict__ h_last, long long batch, long long S,
              long long W) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (lane >= batch * W) return;
  const long long bi = lane / W;
  const long long w = lane - bi * W;
  const long long base = bi * S * W + w;
  float h = to_f32(h0[lane]);
  long long t = 0;
  for (; t + kChunk <= S; t += kChunk) {
    float la[kChunk], bb[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const long long o = base + (t + u) * W;
      la[u] = to_f32(log_a[o]);
      bb[u] = to_f32(b[o]);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      h = expf(la[u]) * h + bb[u];
      store(hs + base + (t + u) * W, h);
    }
  }
  for (; t < S; ++t) {
    const long long o = base + t * W;
    h = expf(to_f32(log_a[o])) * h + to_f32(b[o]);
    store(hs + o, h);
  }
  store(h_last + lane, h);
}

template <typename T>
int launch(const void* log_a, const void* b, const void* h0, void* hs,
           void* h_last, long long batch, long long S, long long W,
           cudaStream_t stream) {
  const long long lanes = batch * W;
  if (lanes == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) /
                                                kThreads);
  rg_lru_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(b),
      static_cast<const T*>(h0), static_cast<T*>(hs),
      static_cast<T*>(h_last), batch, S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// log_a, b, hs: (batch, S, W); h0, h_last: (batch, W); all contiguous,
// float32 (bf16 = 0) or bfloat16 (bf16 = 1).
int rg_lru(const void* log_a, const void* b, const void* h0, void* hs,
           void* h_last, long long batch, long long S, long long W, int bf16,
           void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(log_a, b, h0, hs, h_last, batch, S, W,
                                 as_stream(stream));
  }
  return launch<float>(log_a, b, h0, hs, h_last, batch, S, W,
                       as_stream(stream));
}

}  // extern "C"
