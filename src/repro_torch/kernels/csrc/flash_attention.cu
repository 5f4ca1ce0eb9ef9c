// Flash attention for the prefill of the LM serving path, for Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into one
// shared library and bound with ctypes: plain C entry points, no PyTorch
// headers.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas:
//   out[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h/g, j])))
//                  . v[b, h/g, j]
// over q (B, Hq, S, D) and k, v (B, Hkv, T, D) in float32 or bfloat16,
// with GQA/MQA (query head h reads kv head h / (Hq / Hkv)), a causal mask
// on absolute positions (query position q_offset + i), a sliding window
// (q_pos - k_pos < window), a logit softcap (cap * tanh(x / cap)) and a
// runtime kv_len (keys at k_pos >= kv_len are masked).  The mask is the
// JAX kernel's exactly; a row with no live key gives 0, because l is
// clamped at 1e-30 as there.
//
// What bounds it on the H100: operations.  4 D flops per live (query,
// key) pair against 2 D bytes per query row and key row in bf16: at the
// path's shape (S = 3072, window 2048, 10 heads, D = 256) 4.3e10 flops
// and 34.6 MB, so 0.043 ms on the bf16 tensor cores and 0.64 ms on the
// float32 CUDA cores, against 0.010 ms for the bytes.
//
// What the design does about it, in this first form: it computes on the
// CUDA cores in float32 (no tensor cores yet) and keeps everything of the
// online softmax on chip.  One block of 256 threads takes one (batch,
// query head, tile of 64 query rows).  Its Q tile, a 32-key K tile and V
// tile and the tile of probabilities live in shared memory as float32
// (148 KB at D = 256); m, l and the 64 x D accumulator live in registers,
// each thread holding 4 rows x (D / 16) columns.  Q and K are stored
// transposed, so the score product reads 4 query values as one 16-byte
// load and 2 keys as one 8-byte load per step of D: two loads for eight
// FMAs.  The keys a block visits are only those its rows can see: the
// causal bound, the window and kv_len cut the tile loop, so blocks that
// the mask removes entirely are never computed, as the TPU kernel's
// pl.when skips them.  Any S and T: the ragged edge is masked, and keys
// past kv_len are neither loaded nor counted.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  The launch goes on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 16 row groups of 4 rows x 16 lanes
constexpr int kQS = kBQ + 4;     // row stride (floats) of Q^T and P^T
constexpr int kKS = kBK + 4;     // row stride (floats) of K^T
constexpr float kNegInf = -1e30f;

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

template <int kD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kD) * kQS + size_t(kD) * kKS + size_t(kBK) * kD +
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

// kD: the largest head dim this instance takes (a multiple of 64); the
// runtime D <= kD.  Columns and rows past D are zero in shared memory.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       long long hq, long long hkv, long long S,
                       long long T_, int D, float scale, float softcap,
                       int causal, long long window, long long kv_end,
                       long long q_offset) {
  constexpr int kCols = kD / 64;   // 4-column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                // [kD][kQS]  Q^T, scaled
  float* kt = qt + kD * kQS;       // [kD][kKS]  K^T
  float* vs = kt + kD * kKS;       // [kBK][kD]  V
  float* pt = vs + kBK * kD;       // [kBK][kQS] P^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4;         // rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;         // keys 2 tx, 2 tx + 1; columns 4 tx + 64 c
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBQ;
  const int rows = static_cast<int>(min(static_cast<long long>(kBQ),
                                        S - row0));
  const long long hk = h / (hq / hkv);
  const T* qb = q + ((b * hq + h) * S + row0) * D;
  const T* kb = k + (b * hkv + hk) * T_ * D;
  const T* vb = v + (b * hkv + hk) * T_ * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    qt[d * kQS + r] = r < rows ? to_f32(qb[static_cast<long long>(r) * D + d])
                                     * scale
                               : 0.f;
  }
  for (int e = tid; e < kBK * kD; e += kThreads) vs[e] = 0.f;

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
      float kv = 0.f, vv = 0.f;
      if (kp < kv_end) {
        kv = to_f32(kb[kp * D + d]);
        vv = to_f32(vb[kp * D + d]);
      }
      kt[d * kKS + j] = kv;
      vs[j * kD + d] = vv;
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
      const float* vrow = vs + j * kD + 4 * tx;
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

  T* ob = out + ((b * hq + h) * S + row0) * D;
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
        if (col < D) {
          store(ob + static_cast<long long>(r) * D + col,
                acc[i][4 * c + e] / li);
        }
      }
    }
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out,
           long long batch, long long hq, long long hkv, long long S,
           long long T_, long long D, float scale, float softcap, int causal,
           long long window, long long kv_end, long long q_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(batch));
  flash_attention_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, S, T_,
      static_cast<int>(D), scale, softcap, causal, window, kv_end, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             long long batch, long long hq, long long hkv, long long S,
             long long T_, long long D, float scale, float softcap,
             int causal, long long window, long long kv_end,
             long long q_offset, cudaStream_t stream) {
  if (D <= 64) {
    return launch<T, 64>(q, k, v, out, batch, hq, hkv, S, T_, D, scale,
                         softcap, causal, window, kv_end, q_offset, stream);
  }
  if (D <= 128) {
    return launch<T, 128>(q, k, v, out, batch, hq, hkv, S, T_, D, scale,
                          softcap, causal, window, kv_end, q_offset, stream);
  }
  return launch<T, 256>(q, k, v, out, batch, hq, hkv, S, T_, D, scale,
                        softcap, causal, window, kv_end, q_offset, stream);
}

}  // namespace

extern "C" {

// q: (batch, hq, S, D); k, v: (batch, hkv, T, D); out like q; all
// contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1).  0 < D <= 256,
// hq % hkv == 0, S >= 1.  softcap <= 0 means none; window is the sliding
// window (the caller passes a value past any position for none); kv_end =
// min(kv_len, T).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    long long batch, long long hq, long long hkv,
                    long long S, long long T, long long D, float scale,
                    float softcap, int causal, long long window,
                    long long kv_end, long long q_offset, int bf16,
                    void* stream) {
  if (D < 1 || D > 256 || hkv < 1 || hq % hkv != 0 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, hq, hkv, S, T, D,
                                   scale, softcap, causal, window, kv_end,
                                   q_offset, as_stream(stream));
  }
  return dispatch<float>(q, k, v, out, batch, hq, hkv, S, T, D, scale,
                         softcap, causal, window, kv_end, q_offset,
                         as_stream(stream));
}

}  // extern "C"
