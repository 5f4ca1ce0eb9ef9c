// The RG-LRU linear recurrence of the recurrentgemma prefill, for Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into one
// shared library and bound with ctypes: plain C entry points, no PyTorch
// headers.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rg_lru/kernel.py:50,
// rg_lru_pallas:
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0
// over log_a, b (B, S, W) and h0 (B, W), float32 or bfloat16, returning
// every h_t (B, S, W) and h_last (B, W) in the inputs' type.  The carried
// state stays in float32 from h0 to h_last, as the TPU kernel keeps it in
// VMEM scratch.
//
// What bounds it on the H100: bytes.  Three flops per element (exp, mul,
// add) against 12 bytes in float32 (two reads, one write): at the path's
// shape (S = 3072, W = 2560) 94.4 MB, 0.028 ms at 3.35 TB/s.  The TPU
// kernel meets that floor by carrying h across the sequential time axis
// of its grid; blocks on the card run in parallel and in no order.
//
// What the design does about it: one launch, a chained scan that folds
// aggregates, reading log_a and b from device memory once and writing
// each h_t once.  Time is cut into chunks of 128 steps and a step's row
// into groups of 256 bytes of lanes (64 float32 or 128 bf16 lanes): a
// tile is one (chunk, lane group), 64 KB of log_a and b, and a block of
// 256 threads holds one, three blocks an SM.  Each lane of a tile is
// walked by kParts threads, one part of 128 / kParts steps each (4 parts
// of 32 steps in float32, 2 of 64 in bf16), so that a tile's walks run on
// 8 warps.  A block:
//   1. Takes an integer ticket (one atomicAdd on the wrapper's counter)
//      and reads its tile from it, chunk-major: every block of chunk c - 1
//      holds its ticket before any block of chunk c.  The ticket only hands
//      out work; the block that takes the last one resets the counter for
//      the next call on the stream.
//   2. Brings its tile into shared memory by TMA in stages of 16 steps (a
//      3-d map over (W, S, B), so a ragged last chunk reads zeros, never
//      the next batch's rows; one mbarrier a stage), or, where a step's row
//      is not a multiple of 16 bytes or a base is not 16-byte aligned, by
//      its threads (each its own part of its lane's column).
//   3. Walks each part from a zero state as its stages land, to the part's
//      aggregate: the decay sum_t log_a_t and the end state.  Each chunk
//      but the last folds its parts' aggregates in order into its own and
//      publishes it: a 64-bit word for its decay and one for its end state
//      (the float low, the call's tag high, which the wrapper raises every
//      call), in the wrapper's int64 state.  A word is written and read
//      whole, so it carries its own validity: no flag, no fence (a release
//      flag's fence waits behind the SM's outstanding stores).
//   4. Folds its predecessors, chunks 0 .. c - 1 of its lanes, cut into
//      kParts runs: each thread folds one run's words in order into one
//      aggregate (decays summed, ends carried), the words loaded before the
//      walk and reloaded until they hold the call's tag, and part 0 applies
//      the runs in order to h0, h = exp(decay) h + end.  No chain runs
//      across chunks: every aggregate is computed at once, and a block
//      waits at most for its predecessors' first walk.  A block waits only
//      on blocks that hold smaller tickets, so are running, and that
//      publish before they wait: no deadlock, whatever order the card runs
//      blocks in.
//   5. Takes each part's entering state through the parts before it,
//      re-walks the tile from shared memory and writes each h_t over its
//      log_a; the tile goes out by TMA stores (rows and lanes past the
//      tensor's edge are not written).  The threads' loader stores each h_t
//      from registers instead (a warp 32 neighbouring lanes of one step).
//      The last chunk writes h_last.
// Every sum runs in a fixed order and no float sum uses atomics, so two
// calls give the same bits.  The parts re-associate the two-launch scan
// that this replaced (a chunk's aggregate is its parts' folded, not one
// walk of 128 steps), so the bits are not that scan's.  S no larger than
// 128 is one chunk; S = 0 writes h_last = h0.  Every wait is bounded
// (about 40 s, then a trap), so a broken chain fails the launch instead of
// holding the card.
//
// The entry returns the first cudaGetLastError() that is not 0; the
// Python wrapper raises then.  The launch goes on the caller's stream.

#include "hopper_bf16.cuh"

namespace {

constexpr int kRowBytes = 256;      // bytes of a step's row a tile holds
constexpr int kChunk = 128;         // steps of a tile
constexpr int kStage = 16;          // steps a TMA box (and an mbarrier) holds
constexpr int kStages = kChunk / kStage;
constexpr int kThreads = 256;       // a block: 4 parts of 64 float32 lanes,
                                    // or 2 parts of 128 bf16 lanes
constexpr int kBlocksPerSm = 3;     // 64 KB tiles: three an SM
constexpr int kAhead = 8;           // predecessors' words a thread loads
                                    // before its tile's walk
constexpr int kTileBytes = 2 * kChunk * kRowBytes;
constexpr long long kWaitClocks = 1LL << 36;   // about 40 s
// lanes of a tile: 64 float32 or 128 bf16
template <typename T>
constexpr int kLanesOf = kRowBytes / static_cast<int>(sizeof(T));

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

// An aggregate's word: the float's bits low, the call's tag high, written
// and read whole (an aligned 64-bit access is single-copy atomic), so a
// reader that sees the tag sees the value, with no fence on either side.
__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned tag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}
// The value of the word at p, loaded as w, once it holds this call's tag:
// reloads until it does, bounded like mbar_wait.
__device__ __forceinline__ float value(const unsigned long long* p,
                                       unsigned long long w, unsigned tag) {
  if (static_cast<unsigned>(w >> 32) != tag) {
    const long long start = clock64();
    do {
      __nanosleep(64);
      if (clock64() - start > kWaitClocks) __trap();
      w = load_word(p);
    } while (static_cast<unsigned>(w >> 32) != tag);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

// The shape of a call, as the kernel reads it.
struct Scan {
  long long S, W, lanes;            // lanes = B W
  long long wgroups, ngroups;       // lane groups a batch row, in all
  int nc;                           // chunks
  unsigned tag;
};

// A block: one tile.  state: [0] the ticket counter, then each chunk but
// the last's aggregate, (nc - 1, 2, lanes) words: its decay, then its end
// state, tagged.
template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rg_lru_kernel(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_h,
              const T* __restrict__ log_a, const T* __restrict__ b,
              const T* __restrict__ h0, T* __restrict__ hs,
              T* __restrict__ h_last, unsigned long long* __restrict__ state,
              const Scan sc) {
  constexpr int kLanes = kLanesOf<T>;
  constexpr int kParts = kThreads / kLanes;
  constexpr int P = kChunk / kParts;                // steps a part
  extern __shared__ __align__(128) unsigned char smem[];
  T* la_s = reinterpret_cast<T*>(smem);             // [kChunk][kLanes]
  T* b_s = la_s + kChunk * kLanes;
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ float part_d[kParts][kLanes], part_e[kParts][kLanes];
  __shared__ float run_d[kParts][kLanes], run_e[kParts][kLanes];
  __shared__ float h_in[kLanes];
  __shared__ long long ticket_s;
  const int tid = threadIdx.x;
  const int l = tid % kLanes, j = tid / kLanes;
  const int p0 = j * P;
  unsigned long long* agg = state + 1;

  // 1. the block's ticket names its tile
  if (tid == 0) {
    const unsigned long long t = atomicAdd(state, 1ULL);
    if (t == gridDim.x - 1) *state = 0;             // the last: reset
    ticket_s = static_cast<long long>(t);
  }
  __syncthreads();
  const long long ticket = ticket_s;
  const int c = static_cast<int>(ticket / sc.ngroups);
  const long long grp = ticket - c * sc.ngroups;
  const long long bi = grp / sc.wgroups;
  const long long w0 = (grp - bi * sc.wgroups) * kLanes;
  const long long t0 = static_cast<long long>(c) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                     sc.S - t0));
  const int stages = (n + kStage - 1) / kStage;
  const int p1 = min(p0 + P, n);                    // this part's steps
  const long long w = w0 + l;
  const bool live = w < sc.W;
  const long long lane = bi * sc.W + w;             // in (B, W)
  const long long o = (bi * sc.S + t0) * sc.W + w;  // step t0, this lane

  // 2. the tile
  if (kTma && tid == 0) {
    prefetch_tensor_map(&tm_a);
    prefetch_tensor_map(&tm_b);
    for (int s = 0; s < stages; ++s) mbar_init(smem_addr(&bars[s]), 1);
    mbar_init_fence();
    for (int s = 0; s < stages; ++s) {
      const uint32_t bar = smem_addr(&bars[s]);
      mbar_arrive_expect_tx(bar, 2 * kStage * kRowBytes);
      const int row = static_cast<int>(t0) + s * kStage;
      tma_load_3d(smem_addr(la_s + s * kStage * kLanes), &tm_a,
                  static_cast<int>(w0), row, static_cast<int>(bi), bar);
      tma_load_3d(smem_addr(b_s + s * kStage * kLanes), &tm_b,
                  static_cast<int>(w0), row, static_cast<int>(bi), bar);
    }
  }
  // this thread's run of the predecessors, chunks r0 .. r1 - 1 of its
  // lane (part j the j-th of kParts runs), the first kAhead words
  // loaded now and read after the walk; part 0 loads h0
  const int q = (c + kParts - 1) / kParts;
  const int r0 = min(j * q, c), r1 = min(r0 + q, c);
  unsigned long long ahead_d[kAhead], ahead_e[kAhead];
#pragma unroll
  for (int r = 0; r < kAhead; ++r) {
    if (live && r0 + r < r1) {
      const unsigned long long* pd = agg + 2LL * (r0 + r) * sc.lanes + lane;
      ahead_d[r] = load_word(pd);
      ahead_e[r] = load_word(pd + sc.lanes);
    }
  }
  const float h_first = j == 0 && live ? to_f32(h0[lane]) : 0.f;
  if (!kTma && live) {
#pragma unroll 8
    for (int i = p0; i < p1; ++i) {
      la_s[i * kLanes + l] = log_a[o + i * sc.W];
      b_s[i * kLanes + l] = b[o + i * sc.W];
    }
  }
  __syncthreads();                                  // the barriers' init

  // 3. each part's aggregate from a zero state, as its stages land
  {
    float decay = 0.f, end = 0.f;
    for (int t1 = p0; t1 < p1; t1 += kStage) {
      if (kTma) mbar_wait(smem_addr(&bars[t1 / kStage]), 0);
      if (t1 + kStage <= p1) {
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = (t1 + u) * kLanes + l;
          const float la = to_f32(la_s[i]);
          end = expf(la) * end + to_f32(b_s[i]);
          decay += la;
        }
      } else {
        for (int i1 = t1; i1 < p1; ++i1) {
          const int i = i1 * kLanes + l;
          const float la = to_f32(la_s[i]);
          end = expf(la) * end + to_f32(b_s[i]);
          decay += la;
        }
      }
    }
    part_d[j][l] = decay;
    part_e[j][l] = end;
  }
  __syncthreads();
  // the chunk's aggregate (every chunk but the last), published at once
  if (j == 0 && live && c < sc.nc - 1) {
    float decay = part_d[0][l], end = part_e[0][l];
#pragma unroll
    for (int i = 1; i < kParts; ++i) {
      end = expf(part_d[i][l]) * end + part_e[i][l];
      decay += part_d[i][l];
    }
    publish(agg + 2LL * c * sc.lanes + lane, decay, sc.tag);
    publish(agg + (2LL * c + 1) * sc.lanes + lane, end, sc.tag);
  }

  // 4. the entering state: each thread folds its run of predecessors in
  // order into one aggregate (decays summed, ends carried), and part 0
  // applies the runs in order to h0
  {
    float decay = 0.f, end = 0.f;
    if (live) {
      for (int i = r0; i < r1; ++i) {
        const unsigned long long* pd = agg + 2LL * i * sc.lanes + lane;
        float d = 0.f, e = 0.f;
        if (i - r0 < kAhead) {
          // the words loaded ahead (a constant index once unrolled)
#pragma unroll
          for (int r = 0; r < kAhead; ++r) {
            if (r == i - r0) {
              d = value(pd, ahead_d[r], sc.tag);
              e = value(pd + sc.lanes, ahead_e[r], sc.tag);
            }
          }
        } else {
          d = value(pd, load_word(pd), sc.tag);
          e = value(pd + sc.lanes, load_word(pd + sc.lanes), sc.tag);
        }
        end = expf(d) * end + e;
        decay += d;
      }
    }
    run_d[j][l] = decay;
    run_e[j][l] = end;
  }
  __syncthreads();
  if (j == 0) {
    float h = h_first;
#pragma unroll
    for (int i = 0; i < kParts; ++i) h = expf(run_d[i][l]) * h + run_e[i][l];
    h_in[l] = h;
  }
  __syncthreads();

  // 5. each part's entering state through the parts before it, then its
  // h_t: over its log_a in the tile for a TMA store, or stored
  float h = h_in[l];
  for (int i = 0; i < j; ++i) h = expf(part_d[i][l]) * h + part_e[i][l];
  for (int t1 = p0; t1 < p1; t1 += kStage) {
    if (t1 + kStage <= p1) {
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = (t1 + u) * kLanes + l;
        h = expf(to_f32(la_s[i])) * h + to_f32(b_s[i]);
        if (kTma) {
          store(la_s + i, h);
        } else if (live) {
          store(hs + o + (t1 + u) * sc.W, h);
        }
      }
    } else {
      for (int i1 = t1; i1 < p1; ++i1) {
        const int i = i1 * kLanes + l;
        h = expf(to_f32(la_s[i])) * h + to_f32(b_s[i]);
        if (kTma) {
          store(la_s + i, h);
        } else if (live) {
          store(hs + o + i1 * sc.W, h);
        }
      }
    }
  }
  // the last chunk's h_last: from the part that holds its last step
  if (c == sc.nc - 1 && live && j == (n > 0 ? (n - 1) / P : 0)) {
    store(h_last + lane, h);
  }
  if (kTma) {
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        tma_store_3d(&tm_h, smem_addr(la_s + s * kStage * kLanes),
                     static_cast<int>(w0),
                     static_cast<int>(t0) + s * kStage,
                     static_cast<int>(bi));
      }
      bulk_commit();
      bulk_wait_read<0>();
    }
  }
}

// The tensor map of a (batch, S, W) tensor in boxes of kLanes lanes by
// kStage steps of one batch row, unswizzled; reads past W or S give zeros,
// stores there are dropped.  Needs W sizeof(T) a multiple of 16 bytes and
// a 16-byte aligned base.
template <typename T>
bool scan_map(CUtensorMap* map, const void* base, long long batch,
              long long S, long long W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr int kLanes = kLanesOf<T>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(W * sizeof(T)),
      static_cast<cuuint64_t>(S * W * sizeof(T))};
  const cuuint32_t box[3] = {kLanes, kStage, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kTma>
int launch_as(const CUtensorMap (&maps)[3], const void* log_a, const void* b,
              const void* h0, void* hs, void* h_last, void* state,
              const Scan& sc, cudaStream_t stream) {
  const auto kernel = rg_lru_kernel<T, kTma>;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes));
  if (err != 0) return err;
  const long long blocks = sc.nc * sc.ngroups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kTileBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(log_a),
      static_cast<const T*>(b), static_cast<const T*>(h0),
      static_cast<T*>(hs), static_cast<T*>(h_last),
      static_cast<unsigned long long*>(state), sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* log_a, const void* b, const void* h0, void* hs,
           void* h_last, void* state, unsigned tag, long long batch,
           long long S, long long W, int tma, cudaStream_t stream) {
  if (batch * W == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kLanes = kLanesOf<T>;
  Scan sc;
  sc.S = S;
  sc.W = W;
  sc.lanes = batch * W;
  sc.nc = S > kChunk ? static_cast<int>((S + kChunk - 1) / kChunk) : 1;
  sc.wgroups = (W + kLanes - 1) / kLanes;
  sc.ngroups = batch * sc.wgroups;
  sc.tag = tag;
  CUtensorMap maps[3] = {};
  if (tma) {
    if (S < 1 || (W * static_cast<long long>(sizeof(T))) % 16 ||
        !aligned16(log_a) || !aligned16(b) || !aligned16(hs) ||
        !scan_map<T>(&maps[0], log_a, batch, S, W) ||
        !scan_map<T>(&maps[1], b, batch, S, W) ||
        !scan_map<T>(&maps[2], hs, batch, S, W)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_as<T, true>(maps, log_a, b, h0, hs, h_last, state, sc,
                              stream);
  }
  return launch_as<T, false>(maps, log_a, b, h0, hs, h_last, state, sc,
                             stream);
}

}  // namespace

extern "C" {

// log_a, b, hs: (batch, S, W); h0, h_last: (batch, W); all contiguous,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  chunk: the steps of a
// tile, 128.  state: int64, the ticket counter (0 before the call; the
// call leaves it 0), then 2 (nc - 1) batch W aggregate words, nc =
// ceil(S / 128), none holding tag in its high half; one stream's calls
// share it, one at a time, each with a new tag (1 .. 2^32 - 1).  loader: 1
// for TMA (W times the element size a multiple of 16 bytes, 16-byte
// aligned log_a, b and hs, S >= 1), 0 for the block's threads.  S = 0
// writes h_last = h0.
int rg_lru(const void* log_a, const void* b, const void* h0, void* hs,
           void* h_last, void* state, long long tag, long long batch,
           long long S, long long W, long long chunk, int is_bf16,
           int loader, void* stream) {
  if (S < 0 || batch < 0 || W < 0 || chunk != kChunk || tag < 1 ||
      tag > 0xffffffffLL || S > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto t = static_cast<unsigned>(tag);
  if (is_bf16) {
    return launch<__nv_bfloat16>(log_a, b, h0, hs, h_last, state, t, batch,
                                 S, W, loader, as_stream(stream));
  }
  return launch<float>(log_a, b, h0, hs, h_last, state, t, batch, S, W,
                       loader, as_stream(stream));
}

}  // extern "C"
