// Flash attention for the prefill of the LM serving path, for Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into one
// shared library and bound with ctypes: plain C entry points, no PyTorch
// headers.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas:
//   out[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h/g, j])))
//                  . v[b, h/g, j]
// over q (B, Hq, S, D), k (B, Hkv, T, D) and v (B, Hkv, T, Dv), out (B, Hq,
// S, Dv): v's head dim is its own, as MLA's prefill has it (D = qk_nope +
// qk_rope against Dv = v_head: 192 / 128 for deepseek-v2-lite, 96 / 64
// for minicpm3).  GQA/MQA (query head h reads kv head h / (Hq / Hkv)), a
// causal mask on absolute positions (query position q_offset + i), a
// sliding window (q_pos - k_pos < window), a logit softcap (cap * tanh(x /
// cap)) and a runtime kv_len (keys at k_pos >= kv_len are masked).  The
// mask is the JAX kernel's exactly; a row with no live key gives 0,
// because l is clamped at 1e-30 as there.  Two routes, one C entry each:
// flash_attention_bf16 (bf16 operands, the tensor cores) and
// flash_attention_f32 (float32 operands, the CUDA cores: TF32 products
// would not hold the float32 path's tolerance).
//
// What bounds it on the H100: the bf16 tensor cores, with the MUFU's exp2
// close behind at a small D.  2 (D + Dv) flops per live (query, key) pair
// against 2 D bytes per query and key row and 2 Dv per value and output
// row: at recurrentgemma's shape (S = 3072, window 2048, 10 heads, D = Dv
// = 256) 4.3e10 flops and 34.6 MB, 0.043 ms on the tensor cores against
// 0.010 ms for the bytes; at llama3.2's causal 2048-token prefill (24
// heads on 8, D = Dv = 128) 2.6e10 flops, 0.026 ms.  Each live pair also
// takes one exp2 on the MUFU, 16 a clock an SM: at minicpm3's D = 96 / Dv
// = 64 (40 heads, 2048 tokens) about 0.023 ms of exp2 beside 0.027 ms of
// products; gemma2's softcap adds a tanh a pair.
//
// The bf16 route, what its design does about each:
// - both products on wgmma.mma_async (m64nNk16, bf16 in, float32
//   accumulators), the only way to the tensor cores' full rate: S = Q K^T
//   with Q and K read from shared memory through descriptors, K-major as
//   they lie in memory; O += P V with P as the register A operand and V
//   transposed by its descriptor.  The accumulator of 16 columns of S is,
//   rounded to bf16 pairs, P's A fragment: P never touches shared memory.
// - TMA loads (cp.async.bulk.tensor, 128-byte swizzle, the layout wgmma's
//   descriptors read without bank conflicts) into a ring of K/V stages.
//   K and V of a stage each have a full mbarrier (the producer's
//   expect_tx, completed by the copy's bytes) and an empty one (each
//   consumer warp's arrival once its products on them are done): K is
//   freed as soon as S is done and is loaded one tile ahead of V, so more
//   of the ring is in flight.  The maps zero-fill past S, kv_end and the
//   row ends, so ragged S, T, D and Dv need no padding loops; an instance
//   pads D to 64, 128, 192 or 256 and Dv to 64, 128 or 256 (D's never
//   below Dv's: the output rows are staged in Q's rows).
// - warp-specialised: a block of 384 threads is a producer warpgroup (one
//   thread issues every load; setmaxnreg hands its registers to the
//   consumers) and two consumer warpgroups of 64 query rows each (a
//   128-row tile, 240 registers a thread).  The consumers issue their
//   products in turns (two named barriers, FA3's ping-pong), so that one's
//   softmax (exp2 on the MUFU) runs beside the other's products; within a
//   consumer, the previous tile's P V runs while this tile's softmax does.
// - shared memory per (D, Dv): Q's 128 rows and 2-4 stages of 128 keys (64
//   at D = 256) within the block's 227 KB, one block an SM: 192 KB at 256 /
//   256, 208 KB at 192 / 128, 224 KB at 128 / 128 and 128 / 64.
// - the softmax keeps the MUFU's work to one ex2.approx a pair, the scale
//   folded into its FFMA; the softcap and the mask are loops of their own
//   under branches taken once a tile (inside the element loop they cost
//   every tile), and the mask compares each constant column with two
//   32-bit bounds a row instead of 64-bit positions per element.
// - masks only where needed: a tile that no row's causal diagonal, window
//   edge, kv_len or ragged end cuts skips the per-element mask; the causal
//   bound, the window and kv_len cut the tile loop, so tiles the mask
//   removes entirely are never visited (the TPU kernel's pl.when); blocks
//   run the longest query tiles first (the grid's fastest index is the
//   head, the tile index runs backwards), so the last wave holds the short
//   ones.
// - rows a tensor map cannot describe (D or Dv * 2 bytes not a multiple of
//   16, or a base off 16-byte alignment) take the same kernel with its
//   producer warpgroup's threads copying the tiles into the same swizzled
//   stages (a template parameter; the wrapper chooses from the shapes and
//   addresses).  No served shape takes it.
// - no atomics and a fixed reduction order: two calls give the same bits.
//
// The float32 route is the first form of this port: float32 on the CUDA
// cores, one block of 256 threads per 64 query rows, Q^T, K^T, V and P^T in
// shared memory as float32 (148 KB at D = Dv = 256), loads then compute.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  The launch goes on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

// ---------------------------------------------------------------------------
// float32 route: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 16 row groups of 4 rows x 16 lanes
constexpr int kQS = kBQ + 4;     // row stride (floats) of Q^T and P^T
constexpr int kKS = kBK + 4;     // row stride (floats) of K^T

template <int kDv>
size_t smem_bytes(long long D) {
  return sizeof(float) *
         (size_t(D) * kQS + size_t(D) * kKS + size_t(kBK) * kDv +
          size_t(kBK) * kQS);
}

// Sum or max over the 16 lanes of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// kDv: the largest value head dim this instance takes (a multiple of 64);
// the runtime Dv <= kDv, and Q^T and K^T take the runtime D's rows.
// Columns of V past Dv are zero in shared memory.
template <int kDv>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, long long hq,
                           long long hkv, long long S, long long T_, int D,
                           int Dv, float scale, float softcap, int causal,
                           long long window, long long kv_end,
                           long long q_offset) {
  constexpr int kCols = kDv / 64;  // 4-column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                // [D][kQS]   Q^T, scaled
  float* kt = qt + D * kQS;        // [D][kKS]   K^T
  float* vs = kt + D * kKS;        // [kBK][kDv] V
  float* pt = vs + kBK * kDv;      // [kBK][kQS] P^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4;         // rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;         // keys 2 tx, 2 tx + 1; columns 4 tx + 64 c
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBQ;
  const int rows = static_cast<int>(min(static_cast<long long>(kBQ),
                                        S - row0));
  const long long hk = h / (hq / hkv);
  const float* qb = q + ((b * hq + h) * S + row0) * D;
  const float* kb = k + (b * hkv + hk) * T_ * D;
  const float* vb = v + (b * hkv + hk) * T_ * Dv;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    qt[d * kQS + r] = r < rows ? qb[static_cast<long long>(r) * D + d] * scale
                               : 0.f;
  }
  for (int e = tid; e < kBK * kDv; e += kThreads) vs[e] = 0.f;

  // The keys any row of this block can see: [lo, hi).
  const long long q_first = q_offset + row0;
  const long long q_last = q_first + rows - 1;
  const long long lo = max(0LL, q_first - window + 1);
  long long hi = kv_end;
  if (causal) hi = min(hi, q_last + 1);

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (long long k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const long long kp = k0 + j;
      kt[d * kKS + j] = kp < kv_end ? kb[kp * D + d] : 0.f;
    }
    for (int e = tid; e < kBK * Dv; e += kThreads) {
      const int j = e / Dv;
      const int d = e - j * Dv;
      const long long kp = k0 + j;
      vs[j * kDv + d] = kp < kv_end ? vb[kp * Dv + d] : 0.f;
    }
    __syncthreads();

    float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kQS +
                                                         4 * ty);
      const float2 kv = *reinterpret_cast<const float2*>(kt + d * kKS +
                                                         2 * tx);
      s[0][0] += qv.x * kv.x; s[0][1] += qv.x * kv.y;
      s[1][0] += qv.y * kv.x; s[1][1] += qv.y * kv.y;
      s[2][0] += qv.z * kv.x; s[2][1] += qv.z * kv.y;
      s[3][0] += qv.w * kv.x; s[3][1] += qv.w * kv.y;
    }

    float p[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qp = q_first + 4 * ty + i;
      bool live[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long kp = k0 + 2 * tx + j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        live[j] = kp < kv_end && (!causal || kp <= qp) && (qp - kp < window);
        s[i][j] = live[j] ? x : kNegInf;
      }
      const float m_new = fmaxf(m[i], group_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
      }
      l[i] = l[i] * alpha + group_sum(p[i][0] + p[i][1]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float4*>(pt + (2 * tx + j) * kQS + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + j * kQS +
                                                         4 * ty);
      const float* vrow = vs + j * kDv + 4 * tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * c);
        acc[0][4 * c + 0] += pv.x * vv.x; acc[0][4 * c + 1] += pv.x * vv.y;
        acc[0][4 * c + 2] += pv.x * vv.z; acc[0][4 * c + 3] += pv.x * vv.w;
        acc[1][4 * c + 0] += pv.y * vv.x; acc[1][4 * c + 1] += pv.y * vv.y;
        acc[1][4 * c + 2] += pv.y * vv.z; acc[1][4 * c + 3] += pv.y * vv.w;
        acc[2][4 * c + 0] += pv.z * vv.x; acc[2][4 * c + 1] += pv.z * vv.y;
        acc[2][4 * c + 2] += pv.z * vv.z; acc[2][4 * c + 3] += pv.z * vv.w;
        acc[3][4 * c + 0] += pv.w * vv.x; acc[3][4 * c + 1] += pv.w * vv.y;
        acc[3][4 * c + 2] += pv.w * vv.z; acc[3][4 * c + 3] += pv.w * vv.w;
      }
    }
    __syncthreads();
  }

  float* ob = out + ((b * hq + h) * S + row0) * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < Dv) {
          ob[static_cast<long long>(r) * Dv + col] = acc[i][4 * c + e] / li;
        }
      }
    }
  }
}

template <int kDv>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               long long batch, long long hq, long long hkv, long long S,
               long long T_, long long D, long long Dv, float scale,
               float softcap, int causal, long long window, long long kv_end,
               long long q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes<kDv>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<kDv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(batch));
  flash_attention_f32_kernel<kDv><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, S, T_,
      static_cast<int>(D), static_cast<int>(Dv), scale, softcap, causal,
      window, kv_end, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma, TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTileQ = 128;            // query rows per block
constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kBf16Threads = 3 * kWg;  // the producer, then two consumers
constexpr int kRowBytes = 128;         // a swizzled row: 64 bf16
constexpr int kSmemMax = 232448;       // shared memory a block can have
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads): consumer c may issue its products
// (kBarTurn + c), consumer c's output rows are staged (kBarOut + c)
constexpr int kBarTurn = 1;
constexpr int kBarOut = 3;

// The shared-memory plan of an instance: Q's 128 rows, then kStages
// stages of kBK keys, K then V, each a set of swizzled 64-column panels,
// then the barriers: Q's, then each stage's K full, V full, K empty and V
// empty.  kBK keys a stage: 128 up to D = 192, 64 at D = 256; as many
// stages (at most 4) as fit.
template <int kD, int kDv>
struct Bf16Plan {
  static_assert(kD % 64 == 0 && kDv % 64 == 0 && kDv <= kD,
                "panels of 64 columns; the output is staged in Q's rows");
  static constexpr int kBK = kD <= 192 ? 128 : 64;
  static constexpr int kQPanel = kTileQ * kRowBytes;
  static constexpr int kKVPanel = kBK * kRowBytes;
  static constexpr int kQBytes = kD / 64 * kQPanel;
  static constexpr int kKBytes = kD / 64 * kKVPanel;
  static constexpr int kStageBytes = kKBytes + kDv / 64 * kKVPanel;
  static constexpr int kFits =
      (kSmemMax - 1024 - 8 * 17 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFits < 4 ? kFits : 4;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 1024: the dynamic base is aligned up to a 1024-byte boundary
  static constexpr int kSmem = kBarOffset + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "two stages must fit");
};

// The threads loader: the producer warpgroup's 128 threads copy kRows rows
// of W <= kW elements (row stride W) into the swizzled panels at dst, rows
// at or past `valid` and columns at or past W as zeros.  For rows a tensor
// map cannot describe (W * 2 bytes not a multiple of 16, or a base off
// 16-byte alignment): element copies, since cp.async moves 4, 8 or 16
// aligned bytes and such a base has none.
template <int kW, int kRows>
__device__ __forceinline__ void fill_tile(unsigned char* dst,
                                          const bf16* src, int valid,
                                          int W) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kRows * kW; e += kWg) {
    const int r = e / kW;
    const int c = e - r * kW;
    const bf16 x =
        r < valid && c < W ? src[static_cast<long long>(r) * W + c] : zero;
    *reinterpret_cast<bf16*>(dst + (c >> 6) * (kRows * kRowBytes) +
                             r * kRowBytes +
                             ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                             ((c & 7) << 1)) = x;
  }
}

// kD, kDv: the instance's head dims of q and k, and of v and the output
// (multiples of 64, kDv <= kD); the runtime D <= kD and Dv <= kDv.  kTma:
// Q, K and V come by TMA through the three tensor maps (zero-filled past
// the row ends, S and kv_end), else by fill_tile from q, k and v.
template <int kD, int kDv, bool kTma>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ out, long long hq,
                            long long hkv, long long S, long long T_, int D,
                            int Dv, float scale, float softcap, int causal,
                            long long window, long long kv_end,
                            long long q_offset, int vec_out) {
  using P = Bf16Plan<kD, kDv>;
  constexpr int kBK = P::kBK;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                   // Q, 128 rows
  unsigned char* stages = smem + P::kQBytes;  // stage s: K, then V
  const uint32_t bar0 = smem_addr(smem + P::kBarOffset);
  const uint32_t bar_q = bar0;
  // stage s's barriers: K or V (kv 0 or 1) loaded, K or V read
  const auto full = [&](int kv, int s) {
    return bar0 + 8 * (1 + kv * kStages + s);
  };
  const auto empty = [&](int kv, int s) {
    return bar0 + 8 * (1 + (2 + kv) * kStages + s);
  };

  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  const long long bh = blockIdx.x;  // b * hq + h
  const long long ntiles = (S + kTileQ - 1) / kTileQ;
  const long long row0 = (ntiles - 1 - blockIdx.y) * kTileQ;
  const int rows = static_cast<int>(min(static_cast<long long>(kTileQ),
                                        S - row0));
  const long long b = bh / hq;
  const long long bkv = b * hkv + (bh - b * hq) / (hq / hkv);

  // The keys any row of this block can see: [lo, hi), in tiles.
  const long long q_first = q_offset + row0;
  const long long q_last = q_first + rows - 1;
  const long long lo = max(0LL, q_first - window + 1);
  long long hi = kv_end;
  if (causal) hi = min(hi, q_last + 1);
  const long long t_begin = lo / kBK;
  const int n_tiles = hi > lo
      ? static_cast<int>((hi + kBK - 1) / kBK - t_begin) : 0;

  if (tid == 0) {
    const uint32_t arrivals = kTma ? 1 : kWg;
    mbar_init(bar_q, arrivals);
    for (int s = 0; s < kStages; ++s) {
      for (int kv = 0; kv < 2; ++kv) {
        mbar_init(full(kv, s), arrivals);
        mbar_init(empty(kv, s), 8);  // each consumer warp
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // -- the producer: Q once, then K and V into the ring, K one tile
    // ahead of V (K(i + 1) before V(i)): the consumers free K(i) once S(i)
    // is done and V(i) only after the next tile's S, so K runs ahead
    if constexpr (kTma) {
      setmaxnreg_dec<24>();
      if (tid == 0 && n_tiles > 0) {
        mbar_arrive_expect_tx(bar_q, P::kQBytes);
        for (int p = 0; p < kD / 64; ++p) {
          tma_load_3d(smem_addr(qs + p * P::kQPanel), &tm_q, 64 * p,
                      static_cast<int>(row0), static_cast<int>(bh), bar_q);
        }
        // tile i's K (kv 0) or V (kv 1) into its stage
        const auto load = [&](int kv, int i) {
          const int s = i % kStages;
          mbar_wait(empty(kv, s), ((i / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(kv, s),
                                kv ? P::kStageBytes - P::kKBytes
                                   : P::kKBytes);
          const int k0 = static_cast<int>((t_begin + i) * kBK);
          unsigned char* dst =
              stages + s * P::kStageBytes + (kv ? P::kKBytes : 0);
          for (int p = 0; p < (kv ? kDv : kD) / 64; ++p) {
            tma_load_3d(smem_addr(dst + p * P::kKVPanel), kv ? &tm_v : &tm_k,
                        64 * p, k0, static_cast<int>(bkv), full(kv, s));
          }
        };
        load(0, 0);
        for (int i = 0; i < n_tiles; ++i) {
          if (i + 1 < n_tiles) load(0, i + 1);
          load(1, i);
        }
      }
    } else {
      setmaxnreg_dec<40>();
      if (n_tiles > 0) {
        fill_tile<kD, kTileQ>(qs, q + (bh * S + row0) * D, rows, D);
        fence_proxy_async();
        mbar_arrive(bar_q);
        const auto load = [&](int kv, int i) {
          const int s = i % kStages;
          mbar_wait(empty(kv, s), ((i / kStages) & 1) ^ 1);
          const long long k0 = (t_begin + i) * kBK;
          const int valid = static_cast<int>(
              min(static_cast<long long>(kBK), kv_end - k0));
          unsigned char* ks = stages + s * P::kStageBytes;
          if (kv) {
            fill_tile<kDv, kBK>(ks + P::kKBytes, v + (bkv * T_ + k0) * Dv,
                                valid, Dv);
          } else {
            fill_tile<kD, kBK>(ks, k + (bkv * T_ + k0) * D, valid, D);
          }
          fence_proxy_async();
          mbar_arrive(full(kv, s));
        };
        load(0, 0);
        for (int i = 0; i < n_tiles; ++i) {
          if (i + 1 < n_tiles) load(0, i + 1);
          load(1, i);
        }
      }
    }
  } else {
    // -- a consumer: 64 query rows, both products on wgmma -------------------
    setmaxnreg_inc<kTma ? 240 : 232>();
    const int c = wg - 1;
    const int ctid = tid - wg * kWg;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int g = lane >> 2;     // accumulator rows g and g + 8 of the warp
    const int tg = lane & 3;     // accumulator columns 2 tg, 2 tg + 1
    const long long q_first_c = q_first + 64 * c;
    const long long qp0 = q_first_c + 16 * warp + g;
    const uint32_t q_addr = smem_addr(qs) + 64 * c * kRowBytes;
    const uint32_t st_addr = smem_addr(stages);
    const float scale_log2 = scale * kLog2e;

    float o[kDv / 2];
#pragma unroll
    for (int j = 0; j < kDv / 2; ++j) o[j] = 0.f;
    float s[kBK / 2];
    uint32_t p[kBK / 16][4];
    float m_row[2] = {kNegInf, kNegInf};  // running max of the logits
    float l_row[2] = {0.f, 0.f};          // this lane's share of the sum

    // S = Q K^T of the tile in stage st into s
    const auto issue_scores = [&](int st) {
      const uint32_t k_addr = st_addr + st * P::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        Wgmma<kBK>::ss(
            s,
            wgmma_desc(q_addr + (kk >> 2) * P::kQPanel + (kk & 3) * 32, 16,
                       1024),
            wgmma_desc(k_addr + (kk >> 2) * P::kKVPanel + (kk & 3) * 32, 16,
                       1024),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage st
    const auto issue_pv = [&](int st) {
      const uint32_t v_addr = st_addr + st * P::kStageBytes + P::kKBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        Wgmma<kDv>::rs_t(o, p[kk],
                         wgmma_desc(v_addr + kk * 16 * kRowBytes,
                                    P::kKVPanel, 1024));
      }
      wgmma_commit();
    };
    // softcap, mask (edge tiles only) and the online softmax of the tile
    // at key k0: s becomes P (unrounded), l_row the new sums, m_row the
    // new maxima (in units of the logits before the scale), alpha each
    // row's rescale of O.  Each step is a loop of its own under a branch
    // taken once a tile, so that a tile without softcap or mask never
    // executes their code; the scale folds into the exp2's FFMA.
    const auto softmax = [&](long long k0, float (&alpha)[2]) {
      float f = scale_log2;   // logits (after the cap) to log2 units
      if (softcap > 0.f) {
        const float inner = scale / softcap;
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) {
          s[j] = softcap * tanhf(s[j] * inner);
        }
        f = kLog2e;
      }
      const bool interior = k0 + kBK <= kv_end &&
                            (!causal || k0 + kBK - 1 <= q_first_c) &&
                            k0 > q_first_c + 63 - window;
      if (!interior) {
        // Element (j, e) is column c = 8 j + e % 2 of this thread's keys
        // k0 + 2 tg + c, on row qp0 + 8 (e / 2); it is live where lower <
        // c <= upper of its row: kp < kv_end, kp <= qp (causal) and qp - kp
        // < window.  The bounds, clamped to +-1024 (c < 256 keeps every
        // comparison's truth), are 32-bit and c is a constant.
        const auto clamp = [](long long x) {
          return static_cast<int>(max(-1024LL, min(1024LL, x)));
        };
        const long long d0 = qp0 - k0 - 2 * tg;  // qp - kp at c = 0
        const int kv_hi = clamp(kv_end - k0 - 2 * tg) - 1;
        int lower[2], upper[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          upper[h] = causal ? min(kv_hi, clamp(d0 + 8 * h)) : kv_hi;
          lower[h] = clamp(d0 + 8 * h - window);
        }
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + (e & 1);
            if (col <= lower[e >> 1] || col > upper[e >> 1]) {
              s[4 * j + e] = __int_as_float(0xff800000);  // -inf: p = 0
            }
          }
        }
      }
      // rows g (e = 0, 1) and g + 8 (e = 2, 3); the max and the sum of a
      // row are four independent chains each (two warps share a
      // scheduler here: a serial chain would leave it waiting on latency)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float part[4] = {m_row[r], m_row[r], m_row[r], m_row[r]};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          part[j & 3] = fmaxf(part[j & 3], fmaxf(s[4 * j + 2 * r],
                                                 s[4 * j + 2 * r + 1]));
        }
        float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = exp2_approx((m_row[r] - mx) * f);
        m_row[r] = mx;
        const float mf = mx * f;
#pragma unroll
        for (int i = 0; i < 4; ++i) part[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float p0 = exp2_approx(fmaf(s[4 * j + 2 * r], f, -mf));
          const float p1 = exp2_approx(fmaf(s[4 * j + 2 * r + 1], f, -mf));
          s[4 * j + 2 * r] = p0;
          s[4 * j + 2 * r + 1] = p1;
          part[j & 3] += p0 + p1;
        }
        l_row[r] = l_row[r] * alpha[r] +
                   ((part[0] + part[1]) + (part[2] + part[3]));
      }
    };
    // O rescaled to the new maxima, P rounded to the next P V's A operand
    const auto rescale_pack = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < kDv / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    if (n_tiles > 0) {
      mbar_wait(bar_q, 0);
      if (c == 1) named_arrive(kBarTurn, 2 * kWg);  // consumer 0 goes first
      // The products are issued in turns with the other consumer (two
      // named barriers), so that its products run while this one's
      // softmax does; the first tile has no P V before it.  Consumer 1
      // does not hand the turn back after its last tile.
      float alpha[2];
      mbar_wait(full(0, 0), 0);
      named_sync(kBarTurn + c, 2 * kWg);
      wgmma_fence();
      issue_scores(0);
      if (c == 0 || n_tiles > 1) named_arrive(kBarTurn + 1 - c, 2 * kWg);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty(0, 0));  // K(0) read
      softmax(t_begin * kBK, alpha);
      rescale_pack(alpha);
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int prev = (i - 1) % kStages;
        mbar_wait(full(0, st), (i / kStages) & 1);
        mbar_wait(full(1, prev), ((i - 1) / kStages) & 1);
        named_sync(kBarTurn + c, 2 * kWg);
        wgmma_fence();
        issue_scores(st);
        issue_pv(prev);
        if (c == 0 || i + 1 < n_tiles) {
          named_arrive(kBarTurn + 1 - c, 2 * kWg);
        }
        wgmma_wait<1>();  // this tile's S; the previous P V runs on
        fence_regs(s);
        if (lane == 0) mbar_arrive(empty(0, st));  // K(i) read
        softmax((t_begin + i) * kBK, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(empty(1, prev));  // V(i - 1) read
        rescale_pack(alpha);
      }
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(full(1, last), ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv(last);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty(1, last));
    }

    // the row sums across the quad, then O / l through this consumer's
    // own Q rows (swizzled as Q was) to whole-row stores
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_row[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
    unsigned char* ow = qs + 64 * c * kRowBytes;
#pragma unroll
    for (int j = 0; j < kDv / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        *reinterpret_cast<uint32_t*>(ow + (j >> 3) * P::kQPanel +
                                     r * kRowBytes +
                                     (((j & 7) ^ (r & 7)) << 4) + 4 * tg) =
            pack_bf16(o[4 * j + 2 * h] * inv[h],
                      o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    named_sync(kBarOut + c, kWg);
    const long long orow0 = row0 + 64 * c;
    const int crows = static_cast<int>(min(64LL, S - orow0));
    bf16* ob = out + (bh * S + orow0) * Dv;
    if (vec_out) {
      constexpr int kChunks = kDv / 8;
      for (int e = ctid; e < 64 * kChunks; e += kWg) {
        const int r = e / kChunks;
        const int cc = e - r * kChunks;
        if (r < crows && 8 * cc < Dv) {
          *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * Dv +
                                    8 * cc) =
              *reinterpret_cast<const uint4*>(
                  ow + (cc >> 3) * P::kQPanel + r * kRowBytes +
                  (((cc & 7) ^ (r & 7)) << 4));
        }
      }
    } else {
      for (int e = ctid; e < 64 * Dv; e += kWg) {
        const int r = e / Dv;
        const int col = e - r * Dv;
        if (r < crows) {
          ob[static_cast<long long>(r) * Dv + col] =
              *reinterpret_cast<const bf16*>(
                  ow + (col >> 6) * P::kQPanel + r * kRowBytes +
                  ((((col >> 3) & 7) ^ (r & 7)) << 4) + ((col & 7) << 1));
        }
      }
    }
  }
}

template <int kD, int kDv, bool kTma>
int launch_bf16_as(const CUtensorMap (&maps)[3], const void* q,
                   const void* k, const void* v, void* out, long long batch,
                   long long hq, long long hkv, long long S, long long T_,
                   long long D, long long Dv, float scale, float softcap,
                   int causal, long long window, long long kv_end,
                   long long q_offset, cudaStream_t stream) {
  using P = Bf16Plan<kD, kDv>;
  const auto kernel = flash_attention_bf16_kernel<kD, kDv, kTma>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_out = Dv % 8 == 0 && aligned16(out);
  // the head (fastest) then the query tile, longest tiles first
  const dim3 grid(static_cast<unsigned>(batch * hq),
                  static_cast<unsigned>((S + kTileQ - 1) / kTileQ));
  kernel<<<grid, kBf16Threads, P::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), hq, hkv, S, T_, static_cast<int>(D),
      static_cast<int>(Dv), scale, softcap, causal, window, kv_end, q_offset,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

// tma: the loader the wrapper chose (ops.py's `loader`): 1 for TMA, which
// needs rows of a multiple of 16 bytes at 16-byte aligned bases, 0 for the
// producer's threads
template <int kD, int kDv>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                long long batch, long long hq, long long hkv, long long S,
                long long T_, long long D, long long Dv, float scale,
                float softcap, int causal, long long window, long long kv_end,
                long long q_offset, int tma, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  if (tma) {
    if (D % 8 || Dv % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // K and V end at kv_end: the keys past it read as zeros
    const long long keys = max(kv_end, 1LL);
    if (!tensor_map(&maps[0], q, D, D, S, S, batch * hq, 64, kTileQ) ||
        !tensor_map(&maps[1], k, D, D, keys, T_, batch * hkv, 64,
                    Bf16Plan<kD, kDv>::kBK) ||
        !tensor_map(&maps[2], v, Dv, Dv, keys, T_, batch * hkv, 64,
                    Bf16Plan<kD, kDv>::kBK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf16_as<kD, kDv, true>(maps, q, k, v, out, batch, hq, hkv,
                                         S, T_, D, Dv, scale, softcap,
                                         causal, window, kv_end, q_offset,
                                         stream);
  }
  return launch_bf16_as<kD, kDv, false>(maps, q, k, v, out, batch, hq, hkv,
                                        S, T_, D, Dv, scale, softcap, causal,
                                        window, kv_end, q_offset, stream);
}

bool bad_shape(long long D, long long Dv, long long hq, long long hkv,
               long long S) {
  return D < 1 || D > 256 || Dv < 1 || Dv > 256 || hkv < 1 || hq % hkv != 0 ||
         S < 1;
}

template <int kA, int kB>
struct Dims {
  static constexpr int kD = kA;
  static constexpr int kDv = kB;
};

// f(Dims<kD, kDv>()) for the instance of head dims (D, Dv): D padded to
// the least of 64, 128, 192 and 256 that holds it and no less than Dv's
// instance; Dv to 64 beside a D of 128 or less, else to 128 or 256.  Six
// instances: those the served configs reach (64/64, 128/64, 128/128,
// 192/128, 256/256) and 256/128, so that a Dv below D never costs O
// registers for D's columns.
template <typename F>
int with_dims(long long D, long long Dv, F&& f) {
  if (Dv <= 64 && D <= 64) return f(Dims<64, 64>());
  if (Dv <= 64 && D <= 128) return f(Dims<128, 64>());
  if (Dv <= 128) {
    if (D <= 128) return f(Dims<128, 128>());
    if (D <= 192) return f(Dims<192, 128>());
    return f(Dims<256, 128>());
  }
  return f(Dims<256, 256>());
}

}  // namespace

extern "C" {

// q: (batch, hq, S, D); k: (batch, hkv, T, D); v: (batch, hkv, T, Dv); out:
// (batch, hq, S, Dv); all contiguous, of the entry's dtype.  0 < D, Dv <=
// 256, hq % hkv == 0, S >= 1.  softcap <= 0 means none; window is the
// sliding window (the caller passes a value past any position for none);
// kv_end = min(kv_len, T).  loader: the bf16 route's (1: TMA, 0: the
// producer's threads; the wrapper's choice); the float32 route loads with
// its block's threads and takes it for the routes' common arguments.

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, long long batch, long long hq,
                         long long hkv, long long S, long long T, long long D,
                         long long Dv, float scale, float softcap, int causal,
                         long long window, long long kv_end,
                         long long q_offset, int loader, void* stream) {
  if (bad_shape(D, Dv, hq, hkv, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = as_stream(stream);
  return with_dims(D, Dv, [&](auto dims) {
    using Dm = decltype(dims);
    return launch_bf16<Dm::kD, Dm::kDv>(q, k, v, out, batch, hq, hkv, S, T,
                                        D, Dv, scale, softcap, causal, window,
                                        kv_end, q_offset, loader, st);
  });
}

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, long long batch, long long hq,
                        long long hkv, long long S, long long T, long long D,
                        long long Dv, float scale, float softcap, int causal,
                        long long window, long long kv_end,
                        long long q_offset, int /*loader*/, void* stream) {
  if (bad_shape(D, Dv, hq, hkv, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = as_stream(stream);
  return with_dims(D, Dv, [&](auto dims) {
    return launch_f32<decltype(dims)::kDv>(q, k, v, out, batch, hq, hkv, S,
                                           T, D, Dv, scale, softcap, causal,
                                           window, kv_end, q_offset, st);
  });
}

}  // extern "C"
