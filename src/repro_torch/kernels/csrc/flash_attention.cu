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
// for minicpm3).  GQA/MQA (query head h
// reads kv head h / (Hq / Hkv)), a causal mask on absolute positions
// (query position q_offset + i), a sliding window (q_pos - k_pos <
// window), a logit softcap (cap * tanh(x / cap)) and a runtime kv_len
// (keys at k_pos >= kv_len are masked).  The mask is the JAX kernel's
// exactly; a row with no live key gives 0, because l is clamped at 1e-30
// as there.  Two routes, one C entry each: flash_attention_bf16 (bf16
// operands, the tensor cores) and flash_attention_f32 (float32 operands,
// the CUDA cores: TF32 products would not hold the float32 path's
// tolerance).
//
// What bounds it on the H100: operations.  2 (D + Dv) flops per live
// (query, key) pair against 2 D bytes per query and key row and 2 Dv per
// value and output row in bf16: at the path's shape (S = 3072, window
// 2048, 10 heads, D = Dv = 256) 4.3e10 flops and 34.6 MB, so 0.043 ms on
// the bf16 tensor cores and 0.64 ms on the float32 CUDA cores, against
// 0.010 ms for the bytes.
//
// The bf16 route, what its design does about that:
// - both products on the tensor cores, mma.sync.m16n8k16 (bf16 in, float32
//   accumulators), fed from shared memory by ldmatrix (ldmatrix.trans for
//   V; the helpers are mma_bf16.cuh's, shared with the mLSTM).  A block
//   of 4 warps takes 64 query rows, 16 a warp; the key loop walks tiles of
//   64 keys.  S = Q K^T is a 16 x 64 accumulator per warp,
//   O a 16 x Dv one (128 registers a thread at Dv = 256, 64 at 128: a Dv
//   below D costs O no registers for D's columns).
// - the operands stay bf16 in shared memory, each row padded by 16 bytes
//   so that ldmatrix's 8 rows fall in distinct banks: Q, one K and one V
//   tile take 101 KB at D = Dv = 256 (69 KB at 192 / 128), so two blocks
//   share an SM.
// - loads overlap compute: K and V tiles are separate cp.async groups.
//   V(t) loads while S(t) = Q K(t)^T computes, K(t + 1) while the softmax
//   and O += P V(t) compute.  Two blocks a SM cover each other's waits.
// - P stays in registers: the scale, softcap, mask and online softmax
//   (row max and sum by quad shuffles, exp2 with the scale folded in) work
//   on the S accumulator fragments, which are rounded to bf16 in place as
//   the A operand of P V.  Nothing of S or P touches shared memory.
// - masks only where needed: a tile that no row's causal diagonal,
//   window edge, kv_len or ragged end cuts skips the per-element mask.
// - the causal bound, the window and kv_len cut the tile loop, so tiles
//   the mask removes entirely are never visited (the TPU kernel's
//   pl.when); blocks run the longest query tiles first (the grid's
//   fastest index is the head, the tile index runs backwards), so the
//   last wave holds the short ones.
// - any S and T; the instance pads D up to 64, 128, 192 or 256 and Dv up
//   to 64, 128 or 256 (D's never below Dv's: the output rows are staged
//   in Q's shared rows), with zeros in shared memory.  Rows of a multiple of
//   8 elements at 16-byte aligned addresses move by cp.async 16 bytes at a
//   time, others element by element.
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

#include "mma_bf16.cuh"

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
// bf16 route: the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;        // query rows per block, 16 per warp
constexpr int kMmaBK = 64;        // keys per tile
constexpr int kMmaThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// bf16 elements per shared row: a width padded by 16 bytes, so that the 8
// rows one ldmatrix reads start in 8 distinct groups of 4 banks
template <int kW>
__host__ __device__ constexpr int mma_stride() { return kW + 8; }

template <int kD, int kDv>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t(kMmaBQ + kMmaBK) * mma_stride<kD>() +
                         size_t(kMmaBK) * mma_stride<kDv>());
}

// kRows rows of D elements from src (row stride D) into shared rows of
// mma_stride<kW>() elements; rows at or past `valid` and columns at or past
// D are zero.  vec: D % 8 == 0 and every operand 16-byte aligned.
template <int kW, int kRows>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int valid, int D, bool vec) {
  constexpr int kStride = mma_stride<kW>();
  if (vec) {
    constexpr int kChunks = kW / 8;
    for (int e = threadIdx.x; e < kRows * kChunks; e += kMmaThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      const bool full = r < valid && c < D;
      cp_async16(smem_u32(dst + r * kStride + c),
                 full ? src + static_cast<long long>(r) * D + c : src, full);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < kRows * kW; e += kMmaThreads) {
      const int r = e / kW;
      const int c = e - r * kW;
      dst[r * kStride + c] = (r < valid && c < D)
                                 ? src[static_cast<long long>(r) * D + c]
                                 : zero;
    }
  }
}

// kD, kDv: the instance's head dims of q and k, and of v and the output
// (multiples of 16, kDv <= kD); the runtime D <= kD and Dv <= kDv.
template <int kD, int kDv>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ out, long long hq,
                            long long hkv, long long S, long long T_, int D,
                            int Dv, float scale, float softcap, int causal,
                            long long window, long long kv_end,
                            long long q_offset, int vec) {
  static_assert(kDv <= kD, "the output rows are staged in Q's rows");
  constexpr int kStride = mma_stride<kD>();
  constexpr int kRowBytes = kStride * 2;
  constexpr int kVStride = mma_stride<kDv>();
  constexpr int kVRowBytes = kVStride * 2;
  constexpr int kDT = kDv / 8;     // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kMmaBQ][kStride]
  bf16* ks = qs + kMmaBQ * kStride;               // [kMmaBK][kStride]
  bf16* vs = ks + kMmaBK * kStride;               // [kMmaBK][kVStride]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;         // accumulator rows g and g + 8
  const int tg = lane & 3;         // accumulator columns 2 tg, 2 tg + 1
  const long long bh = blockIdx.x;                // b * hq + h
  const long long ntiles = (S + kMmaBQ - 1) / kMmaBQ;
  const long long row0 = (ntiles - 1 - blockIdx.y) * kMmaBQ;
  const int rows = static_cast<int>(min(static_cast<long long>(kMmaBQ),
                                        S - row0));
  const long long b = bh / hq;
  const long long hk = (bh - b * hq) / (hq / hkv);
  const bf16* qb = q + (bh * S + row0) * D;
  const bf16* kb = k + (b * hkv + hk) * T_ * D;
  const bf16* vb = v + (b * hkv + hk) * T_ * Dv;
  const bool vec_ok = vec != 0;

  // The keys any row of this block can see: [lo, hi), in tiles.
  const long long q_first = q_offset + row0;
  const long long q_last = q_first + rows - 1;
  const long long lo = max(0LL, q_first - window + 1);
  long long hi = kv_end;
  if (causal) hi = min(hi, q_last + 1);
  const long long t_begin = lo / kMmaBK;
  const long long t_end = hi > lo ? (hi + kMmaBK - 1) / kMmaBK : t_begin;

  load_rows<kD, kMmaBQ>(qs, qb, rows, D, vec_ok);
  if (t_begin < t_end) {
    const long long k0 = t_begin * kMmaBK;
    load_rows<kD, kMmaBK>(ks, kb + k0 * D,
                          static_cast<int>(min(static_cast<long long>(kMmaBK),
                                               kv_end - k0)),
                          D, vec_ok);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane.  Q (A operand): rows
  // lane % 16, columns 8 (lane / 16).  K (B operand, two 8-key tiles):
  // keys lane % 8 + 8 (lane / 16), columns 8 (lane / 8 % 2).  V (B
  // operand transposed, two 8-column tiles): keys lane % 8 + 8 (lane / 8
  // % 2), columns 8 (lane / 16).
  const unsigned q_addr = smem_u32(qs + (16 * warp + (lane & 15)) * kStride +
                                   8 * (lane >> 4));
  const unsigned k_addr = smem_u32(ks + ((lane & 7) + 8 * (lane >> 4)) *
                                            kStride +
                                   8 * ((lane >> 3) & 1));
  const unsigned v_addr = smem_u32(vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) *
                                            kVStride +
                                   8 * (lane >> 4));

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l_row[2] = {0.f, 0.f};          // this lane's share of the row sum
  const float scale_log2 = scale * kLog2e;
  const long long qp0 = q_first + 16 * warp + g;  // rows qp0 and qp0 + 8

  for (long long t = t_begin; t < t_end; ++t) {
    const long long k0 = t * kMmaBK;
    const int valid = static_cast<int>(
        min(static_cast<long long>(kMmaBK), kv_end - k0));
    cp_async_wait_all();
    __syncthreads();   // K(t) is in; every warp is done with V(t - 1)
    load_rows<kDv, kMmaBK>(vs, vb + k0 * Dv, valid, Dv, vec_ok);
    cp_async_commit();

    // S = Q K^T: 16 x 64 a warp, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, k_addr + np * 16 * kRowBytes + kk * 32);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    cp_async_wait_all();
    __syncthreads();   // V(t) is in; every warp is done with K(t)
    if (t + 1 < t_end) {
      const long long k1 = k0 + kMmaBK;
      load_rows<kD, kMmaBK>(ks, kb + k1 * D,
                            static_cast<int>(min(
                                static_cast<long long>(kMmaBK), kv_end - k1)),
                            D, vec_ok);
      cp_async_commit();
    }

    // scale, softcap, mask (edge tiles only), in log2 units
    const bool interior = k0 + kMmaBK <= kv_end &&
                          (!causal || k0 + kMmaBK - 1 <= q_first) &&
                          k0 > q_last - window;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (softcap > 0.f) {
          x = softcap * tanhf(x * scale / softcap) * kLog2e;
        } else {
          x *= scale_log2;
        }
        if (!interior) {
          const long long qp = qp0 + (e >> 1) * 8;
          const long long kp = k0 + 8 * j + 2 * tg + (e & 1);
          const bool live = kp < kv_end && (!causal || kp <= qp) &&
                            qp - kp < window;
          if (!live) x = __int_as_float(0xff800000);   // -inf: p = 0
        }
        s[j][e] = x;
      }
    }

    // online softmax over the tile: rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_row[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_row[r] - mx);
      m_row[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[j][2 * r] - mx);
        const float p1 = exp2f(s[j][2 * r + 1] - mx);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_row[r] = l_row[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P from the S fragments (16 keys a step) as the A operand
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDv / 16; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, v_addr + kk * 16 * kVRowBytes + dp * 32);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // the row sums across the quad, then O / l through this warp's own Q
  // rows (no other warp reads them) to whole-row stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  cp_async_wait_all();   // a block with no key tile still has Q in flight
  __syncthreads();
  bf16* ow = qs + 16 * warp * kStride;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = 8 * j + 2 * tg;
    *reinterpret_cast<__nv_bfloat162*>(ow + g * kStride + c) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * kStride + c) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  const int wrows = min(16, rows - 16 * warp);
  bf16* ob = out + (bh * S + row0 + 16 * warp) * Dv;
  if (vec_ok) {
    constexpr int kChunks = kDv / 8;
    for (int e = lane; e < 16 * kChunks; e += 32) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      if (r < wrows && c < Dv) {
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * Dv + c) =
            *reinterpret_cast<const uint4*>(ow + r * kStride + c);
      }
    }
  } else {
    for (int e = lane; e < 16 * Dv; e += 32) {
      const int r = e / Dv;
      const int c = e - r * Dv;
      if (r < wrows) {
        ob[static_cast<long long>(r) * Dv + c] = ow[r * kStride + c];
      }
    }
  }
}

template <int kD, int kDv>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                long long batch, long long hq, long long hkv, long long S,
                long long T_, long long D, long long Dv, float scale,
                float softcap, int causal, long long window, long long kv_end,
                long long q_offset, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<kD, kDv>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<kD, kDv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const int vec = D % 8 == 0 && Dv % 8 == 0 &&
                  ((addr(q) | addr(k) | addr(v) | addr(out)) & 15) == 0;
  // the head (fastest) then the query tile, longest tiles first
  const dim3 grid(static_cast<unsigned>(batch * hq),
                  static_cast<unsigned>((S + kMmaBQ - 1) / kMmaBQ));
  flash_attention_bf16_kernel<kD, kDv><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, hkv, S, T_,
      static_cast<int>(D), static_cast<int>(Dv), scale, softcap, causal,
      window, kv_end, q_offset, vec);
  return static_cast<int>(cudaGetLastError());
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
// kv_end = min(kv_len, T).

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, long long batch, long long hq,
                         long long hkv, long long S, long long T, long long D,
                         long long Dv, float scale, float softcap, int causal,
                         long long window, long long kv_end,
                         long long q_offset, void* stream) {
  if (bad_shape(D, Dv, hq, hkv, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = as_stream(stream);
  return with_dims(D, Dv, [&](auto dims) {
    using Dm = decltype(dims);
    return launch_bf16<Dm::kD, Dm::kDv>(q, k, v, out, batch, hq, hkv, S, T,
                                        D, Dv, scale, softcap, causal, window,
                                        kv_end, q_offset, st);
  });
}

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, long long batch, long long hq,
                        long long hkv, long long S, long long T, long long D,
                        long long Dv, float scale, float softcap, int causal,
                        long long window, long long kv_end,
                        long long q_offset, void* stream) {
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
