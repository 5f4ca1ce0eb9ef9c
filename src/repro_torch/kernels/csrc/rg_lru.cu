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
// What the design does about it: a chunked two-level scan, so that lanes
// times chunks fill the card.  The first form walked all S steps with one
// thread per (batch, width) lane: 2560 threads on 80 of the 132 SMs, bound
// by the latency of the chain (about 54 ns a step).  Now time is cut into
// chunks of T steps (the wrapper's chunk, 128; 24 chunks and 61,440
// threads at the path's shape), one thread per (lane, chunk), in two
// launches:
//   1. rg_lru_summary_kernel: each chunk but the last walks its steps from
//      a zero state and writes its summary, the decay sum_t log_a_t and
//      the end state, to the wrapper's float32 scratch (2, nc - 1, B W);
//   2. rg_lru_chunk_kernel: each chunk folds the summaries of the chunks
//      before it into h0 in order, h = exp(decay) h + end, and re-walks
//      its own steps from that entering state, writing every h_t; the last
//      chunk writes h_last.
// A warp reads 32 neighbouring lanes of one step, so every load and store
// is coalesced; each thread loads 16 steps while it computes the 16
// before them, and a chunk's first 16 while it folds the summaries.  The
// inputs are read twice: 157 MB at the path's shape, a floor of 0.047 ms.
// Every sum runs in a fixed order and nothing uses atomics, so two calls
// give the same bits.  S no larger than T is one chunk and one launch.
// Measured at the path's shape on an NVIDIA H100 80GB HBM3 at 700 W:
// 0.0583 ms on the device, 0.0622 by events (chip_smoke.py), 1.003-1.010
// ms for a prefill's 18 calls (profile_frame.py --part lm), against 0.1664
// ms a call and 3.04 ms a prefill for the one-pass form.
//
// The entry returns the first cudaGetLastError() that is not 0; the
// Python wrapper raises then.  The launches go on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 16;       // steps loaded before they are computed
constexpr int kFold = 16;        // summaries loaded before they are folded

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
__device__ __forceinline__ void load_batch(const T* __restrict__ log_a,
                                           const T* __restrict__ b,
                                           long long o, long long W,
                                           float (&la)[kBatch],
                                           float (&bb)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    la[u] = to_f32(log_a[o + u * W]);
    bb[u] = to_f32(b[o + u * W]);
  }
}

// kBatch steps from h, the first at offset o: store every h_t (kWrite),
// else sum log_a into decay
template <bool kWrite, typename T>
__device__ __forceinline__ float run_batch(const float (&la)[kBatch],
                                           const float (&bb)[kBatch],
                                           T* __restrict__ hs, long long o,
                                           long long W, float h,
                                           float& decay) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    h = expf(la[u]) * h + bb[u];
    if (kWrite) {
      store(hs + o + u * W, h);
    } else {
      decay += la[u];
    }
  }
  return h;
}

// Walk n steps of one lane from h: o is the offset of the first, W the
// stride of a step.  When n >= kBatch the caller has loaded the first
// batch into (la0, bb0); each further batch loads while the one before it
// computes.
template <bool kWrite, typename T>
__device__ __forceinline__ float walk(const T* __restrict__ log_a,
                                      const T* __restrict__ b,
                                      T* __restrict__ hs, long long o,
                                      long long W, int n, float h,
                                      float& decay, float (&la0)[kBatch],
                                      float (&bb0)[kBatch]) {
  float la1[kBatch], bb1[kBatch];
  int t = 0;
  if (n >= kBatch) {
    while (true) {
      const bool more = t + 2 * kBatch <= n;
      if (more) load_batch(log_a, b, o + (t + kBatch) * W, W, la1, bb1);
      h = run_batch<kWrite>(la0, bb0, hs, o + t * W, W, h, decay);
      t += kBatch;
      if (!more) break;
      const bool more2 = t + 2 * kBatch <= n;
      if (more2) load_batch(log_a, b, o + (t + kBatch) * W, W, la0, bb0);
      h = run_batch<kWrite>(la1, bb1, hs, o + t * W, W, h, decay);
      t += kBatch;
      if (!more2) break;
    }
  }
  for (; t < n; ++t) {
    const float la = to_f32(log_a[o + t * W]);
    h = expf(la) * h + to_f32(b[o + t * W]);
    if (kWrite) {
      store(hs + o + t * W, h);
    } else {
      decay += la;
    }
  }
  return h;
}

// Block (128 lanes, chunk c < nc - 1): the chunk's decay and end state.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_summary_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
                      float* __restrict__ scratch, long long lanes,
                      long long S, long long W, int T_, int nc) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (lane >= lanes) return;
  const long long c = blockIdx.y;
  const long long bi = lane / W;
  const long long o = (bi * S + c * T_) * W + (lane - bi * W);
  float la0[kBatch], bb0[kBatch];
  if (T_ >= kBatch) load_batch(log_a, b, o, W, la0, bb0);
  float decay = 0.f;
  const float end = walk<false>(log_a, b, static_cast<T*>(nullptr), o, W,
                                T_, 0.f, decay, la0, bb0);
  scratch[c * lanes + lane] = decay;
  scratch[(static_cast<long long>(nc) - 1 + c) * lanes + lane] = end;
}

// Block (128 lanes, chunk c): the entering state from h0 and the
// summaries of chunks 0 .. c - 1, then the chunk's outputs.  The chunk's
// first batch of inputs loads before the summaries are folded.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_chunk_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
                    const T* __restrict__ h0, T* __restrict__ hs,
                    T* __restrict__ h_last,
                    const float* __restrict__ scratch, long long lanes,
                    long long S, long long W, int T_, int nc) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (lane >= lanes) return;
  const int c = static_cast<int>(blockIdx.y);
  const long long bi = lane / W;
  const long long t0 = static_cast<long long>(c) * T_;
  const int n = static_cast<int>(min(static_cast<long long>(T_), S - t0));
  const long long o = (bi * S + t0) * W + (lane - bi * W);
  float la0[kBatch], bb0[kBatch];
  if (n >= kBatch) load_batch(log_a, b, o, W, la0, bb0);
  const float* decay = scratch + lane;
  const float* end = scratch + (static_cast<long long>(nc) - 1) * lanes +
                     lane;
  float h = to_f32(h0[lane]);
  int i = 0;
  for (; i + kFold <= c; i += kFold) {
    float d[kFold], e[kFold];
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      d[u] = decay[(i + u) * lanes];
      e[u] = end[(i + u) * lanes];
    }
#pragma unroll
    for (int u = 0; u < kFold; ++u) h = expf(d[u]) * h + e[u];
  }
  for (; i < c; ++i) h = expf(decay[i * lanes]) * h + end[i * lanes];
  float unused = 0.f;
  h = walk<true>(log_a, b, hs, o, W, n, h, unused, la0, bb0);
  if (c == nc - 1) store(h_last + lane, h);
}

template <typename T>
int launch(const void* log_a, const void* b, const void* h0, void* hs,
           void* h_last, void* scratch, long long batch, long long S,
           long long W, int T_, cudaStream_t stream) {
  const long long lanes = batch * W;
  if (lanes == 0) return static_cast<int>(cudaGetLastError());
  const int nc = S > T_ ? static_cast<int>((S + T_ - 1) / T_) : 1;
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) /
                                                kThreads);
  const auto la = static_cast<const T*>(log_a);
  const auto bb = static_cast<const T*>(b);
  const auto sc = static_cast<float*>(scratch);
  if (nc > 1) {
    rg_lru_summary_kernel<T><<<dim3(blocks, nc - 1), kThreads, 0, stream>>>(
        la, bb, sc, lanes, S, W, T_, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rg_lru_chunk_kernel<T><<<dim3(blocks, nc), kThreads, 0, stream>>>(
      la, bb, static_cast<const T*>(h0), static_cast<T*>(hs),
      static_cast<T*>(h_last), sc, lanes, S, W, T_, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// log_a, b, hs: (batch, S, W); h0, h_last: (batch, W); all contiguous,
// float32 (bf16 = 0) or bfloat16 (bf16 = 1).  chunk: steps a thread walks
// (chunk >= 1); scratch: float32 (2, nc - 1, batch, W), nc = ceil(S /
// chunk), not read when nc is at most 1.  S = 0 writes h_last = h0.
int rg_lru(const void* log_a, const void* b, const void* h0, void* hs,
           void* h_last, void* scratch, long long batch, long long S,
           long long W, long long chunk, int bf16, void* stream) {
  if (S < 0 || chunk < 1 || chunk > (1LL << 30) || batch < 0 || W < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int T_ = static_cast<int>(chunk);
  if (bf16) {
    return launch<__nv_bfloat16>(log_a, b, h0, hs, h_last, scratch, batch, S,
                                 W, T_, as_stream(stream));
  }
  return launch<float>(log_a, b, h0, hs, h_last, scratch, batch, S, W, T_,
                       as_stream(stream));
}

}  // extern "C"
