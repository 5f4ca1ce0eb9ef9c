// The chunkwise mLSTM of the xLSTM prefill, for Hopper (sm_90a).  Built by
// repro_torch/kernels/_build.py with nvcc into one shared library and
// bound with ctypes: plain C entry points, no PyTorch headers.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/mlstm/kernel.py,
// mlstm_pallas.  Per (batch, head), over chunks of L steps with the state
// (C, n, m) handed from chunk to chunk (C stored scaled by exp(-m)):
//   c_t = cumsum(log_f) over the chunk,
//   W[t, s] = (c_t - c_s) + log_i_s for s <= t,
//   m_t = max(max_s W[t, s], c_t + m),  D = exp(W - m_t),
//   h_t = ((q k^T . D) v + e^{c_t + m - m_t} q C)_t
//         / max(|q_t . n_t|, e^{-m_t}),
//   n_t = D k + e^{c_t + m - m_t} n,
// then the hand-off C, n, m <- the chunk's decayed k^T v, sum of k and the
// new max.  q is scaled by dk^-1/2; q, k, v are float32 or bfloat16, the
// gates and the state float32, h is written in v's type.  Unlike the TPU
// kernel, which starts from a zero state and needs S divisible by L, this
// one takes an initial state and any S: the last chunk holds S - (nc - 1)
// L steps and is masked, which is what the reference's mlstm_chunkwise
// computes with its no-op padding steps.  Two routes, one C entry each, as
// flash attention has: mlstm_bf16 (bf16 q, k, v: the tensor cores) and
// mlstm_f32 (float32 q, k, v: the CUDA cores, which hold the float32
// path's 1e-4).
//
// What bounds it on the H100: bytes.  At the path's shape (B = 1, H = 4,
// S = 3072, dk = dv = 512, L = 128) the chunkwise form does 1.61e10 flops
// (q k^T and scores v at 2 L^2 512 each, q C and k^T v at 2 L 512^2 each,
// a chunk; n_t = D k is never formed) against 58.8 MB (q, k, v, h in bf16,
// the gates and the state read and written in float32): 0.0176 ms for the
// bytes, 0.0163 ms on the bf16 tensor cores, 0.240 ms on the float32 CUDA
// cores.  At dk = dv = 512 the state is 1 MiB a head, more than a block's
// 227 KB of shared memory, so the states entering the chunks go through a
// scratch in device memory: (BH, nc, dk, dv) elements of 4 bytes, 100.7 MB
// at the path's shape (with the n and three scalars a chunk, 100,861,056
// bytes in all; the wrapper's scratch_bytes).
//
// The bf16 route, two kernels:
//   1. mlstm_state_walk_kernel: one block per (batch x head, 64 x 64 tile
//      of C) walks the chunks in order with its tile of C in the mma
//      accumulators of 8 warps, 16 rows x 32 columns each (256 blocks at
//      the path's shape, two an SM).  Per chunk they store the entering
//      tile to the scratch as a bf16 pair hi + lo (hi the rounded value,
//      lo the rounded rest: 16 bits of mantissa, where TF32 keeps 11 in
//      the tensor-core time of two bf16 products), through each warp's
//      staging rows so that a lane stores 16 bytes of a row; then C <-
//      e^{c_last + m - m'} C + (a . k)^T v on the tensor cores: the
//      fragments of the bf16 k tile are scaled by a_s = e^{w_s - m'} and
//      split hi + lo in registers, v is taken as stored.  A ninth, feeder
//      warp loads the next chunk's k and v (cp.async) and forms its gates
//      meanwhile, so one barrier a chunk hands both over.  n rides along
//      in the column-tile-0 blocks as one more product, (a . k)^T times a
//      column of ones; the feeder of the first block carries m.  The
//      scratch is written once here and read once by pass 2 (201 MB at
//      the path's shape; the float32 route's three passes move 403).
//   2. mlstm_chunk_out_bf16_kernel: one block of 8 warps per chunk (96 at
//      the path's shape, one an SM, 228,352 bytes of shared memory at dk =
//      512: the chunk's q rows, a ring of 4 stages of 18 KB, a v tile).
//      q k^T once per chunk on the tensor cores, q and k as stored, the k
//      slices through the ring, only the key tiles at or below each warp's
//      rows; dk^-1/2 scales the float32 sums.  The decay, the rows' max,
//      the carry and the denominator max(|rowsum P + carry q . n|,
//      e^{-m_t}) from the accumulators with quad shuffles; P stays in
//      registers as the A operand of P v, split hi + lo (rounded to bf16
//      alone, as flash attention rounds its P, it misses the spec's 2e-3 on
//      h at dk = 512: tests/test_torch_mlstm.py emulates both).  Then per
//      64 columns of h: acc = q C over dk from the scratch's hi and lo
//      rows (three ring items in flight), acc = carry dk^-1/2 acc + P v,
//      and h = acc / den in bf16 through the warp's rows of the v tile, 16
//      bytes a lane.  Its q rows in shared memory bound dk at 512 (the
//      served head dim); a wider head runs the CUDA-core passes below in
//      bf16.  Any dv.
// Both run mma.sync.m16n8k16 (bf16 in, float32 accumulators) fed by
// ldmatrix, with the helpers of mma_bf16.cuh.  Measured at the path's
// shape on an NVIDIA H100 80GB HBM3 at 700 W: 0.2536 ms a call by events
// (chip_smoke.py), 5.29 ms of device time for a prefill's 21 calls
// (profile_frame.py --part xlstm), against 1.4523 ms a call and 30.4 ms a
// prefill for the float32-core form.  Both kernels are bound by the rate
// of mma.sync and ldmatrix and by their serial steps, not by bytes: the
// hi + lo products double the tensor-core work of q C and of the state.
//
// The float32 route is this port's first form, on the CUDA cores in three
// passes over a float32 scratch of the same size (bf16 heads wider than
// 512 take the same passes in bf16):
//   1. chunk_state: per (batch, head, chunk, 64 x 64 tile of C) the
//      chunk's own decayed k^T v, its sum of k and the max of its log
//      weights, all chunks in parallel;
//   2. state_scan: one thread per element of C and n walks the chunks in
//      order and leaves, in place, the state that enters each chunk, and
//      the final state; it loads 8 chunks' states before it writes any;
//   3. chunk_out: per (batch, head, chunk, 64 columns of h) the outputs
//      from the entering state: q k^T and q C over dk in steps of 32
//      (q and k stored transposed in shared memory), the decay and the
//      rows' max and sums with warp shuffles, then the scores times v.
//      q . n_t is the row sum of the masked scores plus the carried
//      e^{c_t + m - m_t} q . n, so n_t itself is never formed.  Each of
//      the column tiles of a chunk recomputes q k^T.
//
// Both routes run every sum in a fixed order and use no atomics, so two
// runs give the same bits.  Each C entry launches its kernels on the
// caller's stream and returns the first cudaGetLastError() that is not 0;
// the Python wrapper raises then.  The wrapper allocates the scratch: the
// states (BH, nc, dk, dv) of 4 bytes, the n (BH, nc, dk) and three
// scalars per chunk, all float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxL = 128;       // largest chunk
constexpr float kNeg = -1e30f;

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

// Sum or max over the 16 lanes of a row group (lanes 0-15 or 16-31), in
// a fixed order.
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// The chunk's gates into shared memory: cs = the inclusive cumsum of
// log_f over its n valid steps, lis = log_i.  One warp does it (warp_gates;
// chunk_gates: warp 0), lane l summing steps 4l..4l+3 in order, then a
// shuffle scan of the lanes.
__device__ void warp_gates(const float* __restrict__ li,
                           const float* __restrict__ lf, long long base,
                           int n, float* cs, float* lis, int lane) {
  float part[4];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    run += t < n ? lf[base + t] : 0.f;
    part[u] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    if (t < n) {
      cs[t] = excl + part[u];
      lis[t] = li[base + t];
    }
  }
}
__device__ void chunk_gates(const float* __restrict__ li,
                            const float* __restrict__ lf, long long base,
                            int n, float* cs, float* lis) {
  if (threadIdx.x < 32) warp_gates(li, lf, base, n, cs, lis, threadIdx.x);
}

// ---------------------------------------------------------------------------
// float32 route: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;    // 16 row groups x 16 lanes
constexpr int kTile = 64;        // C tile (dk x dv) of chunk_state
constexpr int kSub = 32;         // steps per sub-chunk of chunk_state
constexpr int kTK = 32;          // dk per step of chunk_out
constexpr int kBV = 64;          // columns of h per chunk_out block
constexpr int kPS = kMaxL + 1;   // row stride (floats) of q^T, k^T, P
constexpr int kScanBatch = 8;    // chunks state_scan loads at once

// Pass 1.  Block (chunk z = bh * nc + j, dk tile, dv tile): the chunk's
// own state Cl[kk, vv] = sum_s e^{w_s - ml} k_s[kk] v_s[vv] with w_s =
// (c_last - c_s) + log_i_s and ml = max_s w_s; the dv tile 0 blocks also
// nl[kk] = sum_s e^{w_s - ml} k_s[kk], the (0, 0) block c_last and ml.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ li,
                   const float* __restrict__ lf, float* __restrict__ cbuf,
                   float* __restrict__ nbuf, float* __restrict__ sbuf,
                   long long BH, long long S, int dk, int dv, int L,
                   int nc) {
  __shared__ float cs[kMaxL], lis[kMaxL], wk[kMaxL];
  __shared__ float ks[kSub][kTile], vs[kSub][kTile];
  __shared__ float red[2];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long z = blockIdx.x;
  const long long bh = z / nc, j = z % nc;
  const int n = static_cast<int>(min(static_cast<long long>(L), S - j * L));
  const long long base = bh * S + j * L;      // the chunk's first step
  chunk_gates(li, lf, base, n, cs, lis);
  __syncthreads();
  if (tid < 32) {
    const float c_last = cs[n - 1];
    float mx = kNeg;
    for (int t = tid; t < n; t += 32) {
      mx = fmaxf(mx, (c_last - cs[t]) + lis[t]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (tid == 0) {
      red[0] = c_last;
      red[1] = mx;
    }
  }
  __syncthreads();
  const float c_last = red[0], ml = red[1];
  for (int t = tid; t < n; t += kThreads) {
    wk[t] = expf((c_last - cs[t]) + lis[t] - ml);
  }
  __syncthreads();

  const int k0 = blockIdx.y * kTile, v0 = blockIdx.z * kTile;
  const bool with_n = blockIdx.z == 0;
  float acc[4][4] = {};
  float nacc[4] = {};
  for (int s0 = 0; s0 < n; s0 += kSub) {
    for (int e = tid; e < kSub * kTile; e += kThreads) {
      const int s = e / kTile, col = e % kTile;
      const bool row = s0 + s < n;
      const long long g = base + s0 + s;
      ks[s][col] = row && k0 + col < dk
                       ? wk[s0 + s] * to_f32(k[g * dk + k0 + col]) : 0.f;
      vs[s][col] = row && v0 + col < dv ? to_f32(v[g * dv + v0 + col])
                                        : 0.f;
    }
    __syncthreads();
    const int ns = min(kSub, n - s0);
    for (int s = 0; s < ns; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ks[s][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = vs[s][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
        }
      }
    }
    if (with_n) {
      for (int s = tx; s < ns; s += 16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) nacc[i] += ks[s][ty + 16 * i];
      }
    }
    __syncthreads();
  }

  float* cl = cbuf + z * dk * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int vv = v0 + tx + 16 * jj;
      if (kk < dk && vv < dv) cl[static_cast<long long>(kk) * dv + vv] =
          acc[i][jj];
    }
  }
  if (with_n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float total = group_sum(nacc[i]);
      const int kk = k0 + ty + 16 * i;
      if (tx == 0 && kk < dk) nbuf[z * dk + kk] = total;
    }
  }
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) {
    sbuf[z] = c_last;
    sbuf[BH * nc + z] = ml;
  }
}

// Pass 2.  Block (element block, bh): each thread one element of C (or of
// n, after the dk x dv of C) walks the chunks in order:
//   m' = max(c_last + m, ml),  x' = e^{c_last + m - m'} x + e^{ml - m'} x_l
// leaving in place of the chunk's own x_l the x that enters the chunk.
// Every thread computes the same m sequence; element 0 stores it.
__global__ void __launch_bounds__(kThreads)
state_scan_kernel(const float* __restrict__ C0, const float* __restrict__ n0,
                  const float* __restrict__ m0, float* __restrict__ C1,
                  float* __restrict__ n1, float* __restrict__ m1,
                  float* __restrict__ cbuf, float* __restrict__ nbuf,
                  float* __restrict__ sbuf, long long BH, int dk, int dv,
                  int nc) {
  const long long bh = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long cells = static_cast<long long>(dk) * dv;
  const bool is_c = e < cells;
  const bool is_n = !is_c && e < cells + dk;
  const float* c_last = sbuf + bh * nc;
  const float* ml = sbuf + BH * nc + bh * nc;
  float* m_in = sbuf + 2 * BH * nc + bh * nc;
  float* buf = nullptr;
  long long stride = 0;
  float x = 0.f;
  if (is_c) {
    buf = cbuf + bh * nc * cells + e;
    stride = cells;
    x = C0[bh * cells + e];
  } else if (is_n) {
    buf = nbuf + bh * nc * dk + (e - cells);
    stride = dk;
    x = n0[bh * dk + (e - cells)];
  }
  float m = m0[bh];
  for (int j0 = 0; j0 < nc; j0 += kScanBatch) {
    // the batch's own states are loaded before any of them is overwritten,
    // so their loads are in flight together, not one round trip a chunk
    float local[kScanBatch];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      local[u] = buf != nullptr && j0 + u < nc ? buf[(j0 + u) * stride]
                                               : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      const int j = j0 + u;
      if (j >= nc) break;
      const float m_new = fmaxf(c_last[j] + m, ml[j]);
      if (e == 0) m_in[j] = m;
      if (buf != nullptr) {
        buf[j * stride] = x;
        x = expf(c_last[j] + m - m_new) * x + expf(ml[j] - m_new) * local[u];
      }
      m = m_new;
    }
  }
  if (is_c) C1[bh * cells + e] = x;
  if (is_n) n1[bh * dk + (e - cells)] = x;
  if (e == 0) m1[bh] = m;
}

constexpr size_t out_smem_floats() {
  return 2 * size_t(kTK) * kPS        // q^T, k^T (then the v tile)
         + size_t(kTK) * kBV + kTK    // the C and n tiles
         + size_t(kMaxL) * kPS        // the masked scores P
         + 2 * size_t(kMaxL);         // c, log_i
}
static_assert(2 * kTK * kPS >= kMaxL * kBV, "v tile overlays q^T, k^T");

// Pass 3.  Block (chunk z, 64 columns of h): thread (ty, tx) holds rows
// t = ty + 16 i (i < 8), score columns s = tx + 16 jj (jj < 8) and h
// columns v0 + tx + 16 jj (jj < 4).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
chunk_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ li,
                 const float* __restrict__ lf,
                 const float* __restrict__ cbuf,
                 const float* __restrict__ nbuf,
                 const float* __restrict__ sbuf, T* __restrict__ h,
                 long long BH, long long S, int dk, int dv, int L, int nc,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                       // [kTK][kPS]
  float* kT = qT + kTK * kPS;             // [kTK][kPS]
  float* vs = smem;                       // [kMaxL][kBV], after the dk loop
  float* Cs = kT + kTK * kPS;             // [kTK][kBV]
  float* nsh = Cs + kTK * kBV;            // [kTK]
  float* Ps = nsh + kTK;                  // [kMaxL][kPS]
  float* cs = Ps + kMaxL * kPS;           // [kMaxL]
  float* lis = cs + kMaxL;                // [kMaxL]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long z = blockIdx.x;
  const long long bh = z / nc, j = z % nc;
  const int n = static_cast<int>(min(static_cast<long long>(L), S - j * L));
  const long long base = bh * S + j * L;
  const int v0 = blockIdx.y * kBV;
  chunk_gates(li, lf, base, n, cs, lis);
  const float m_in = sbuf[2 * BH * nc + z];
  const float* c_in = cbuf + z * dk * dv;
  const float* n_in = nbuf + z * dk;

  float sacc[8][8] = {};   // q k^T (q scaled)
  float qc[8][4] = {};     // q C
  float qn[8] = {};        // q . n, this lane's share of dk
  for (int kk0 = 0; kk0 < dk; kk0 += kTK) {
    __syncthreads();
    for (int e = tid; e < kMaxL * kTK; e += kThreads) {
      const int t = e / kTK, c = e % kTK;
      const bool ok = t < n && kk0 + c < dk;
      const long long g = (base + t) * dk + kk0 + c;
      qT[c * kPS + t] = ok ? scale * to_f32(q[g]) : 0.f;
      kT[c * kPS + t] = ok ? to_f32(k[g]) : 0.f;
    }
    for (int e = tid; e < kTK * kBV; e += kThreads) {
      const int r = e / kBV, c = e % kBV;
      Cs[r * kBV + c] = kk0 + r < dk && v0 + c < dv
                            ? c_in[static_cast<long long>(kk0 + r) * dv +
                                   v0 + c]
                            : 0.f;
    }
    if (tid < kTK) nsh[tid] = kk0 + tid < dk ? n_in[kk0 + tid] : 0.f;
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float a[8], b[8], w[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = qT[c * kPS + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) b[jj] = kT[c * kPS + tx + 16 * jj];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) w[jj] = Cs[c * kBV + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          sacc[i][jj] = fmaf(a[i], b[jj], sacc[i][jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qc[i][jj] = fmaf(a[i], w[jj], qc[i][jj]);
        }
      }
    }
    for (int c = tx; c < kTK; c += 16) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qn[i] = fmaf(qT[c * kPS + ty + 16 * i], nsh[c], qn[i]);
      }
    }
  }

  // the decay, the rows' max and the masked scores P = (q k^T) . D
  float carry[8], den[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
    const bool row = t < n;
    const float ct = row ? cs[t] : 0.f;
    float mx = kNeg;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int s = tx + 16 * jj;
      if (row && s <= t) mx = fmaxf(mx, (ct - cs[s]) + lis[s]);
    }
    mx = group_max(mx);
    const float m_inter = ct + m_in;
    const float m_t = fmaxf(mx, m_inter);
    carry[i] = expf(m_inter - m_t);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int s = tx + 16 * jj;
      float p = 0.f;
      if (row && s <= t) {
        p = sacc[i][jj] * expf((ct - cs[s]) + lis[s] - m_t);
      }
      Ps[t * kPS + s] = p;
      rs += p;
    }
    rs = group_sum(rs);
    const float qnt = group_sum(qn[i]);
    den[i] = fmaxf(fabsf(rs + carry[i] * qnt), expf(-m_t));
  }
  __syncthreads();
  for (int e = tid; e < kMaxL * kBV; e += kThreads) {
    const int s = e / kBV, c = e % kBV;
    vs[e] = s < n && v0 + c < dv ? to_f32(v[(base + s) * dv + v0 + c])
                                 : 0.f;
  }
  __syncthreads();
  float pv[8][4] = {};
  for (int s = 0; s < n; ++s) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = Ps[(ty + 16 * i) * kPS + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) b[jj] = vs[s * kBV + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) pv[i][jj] = fmaf(a[i], b[jj], pv[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = v0 + tx + 16 * jj;
      if (c < dv) {
        store(h + (base + t) * dv + c,
              (pv[i][jj] + carry[i] * qc[i][jj]) / den[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: the tensor cores
// ---------------------------------------------------------------------------

constexpr int kCT = 64;           // C tile of the walk, columns of h a step
constexpr int kTS = kCT + 8;      // bf16 row stride of a 64-wide tile
constexpr int kMmaWarps = 8;      // the walk's: 16 rows x 32 columns each
constexpr int kWalkThreads = 32 * (kMmaWarps + 1);  // and a feeder warp
constexpr int kOutThreads = 256;  // 8 warps, 16 rows of the chunk each
constexpr int kStages = 4;        // ring stages of the output pass
constexpr int kStage = kMaxL * kTS;  // bf16 a stage: a k slice [128][72] or
                                     // C hi and lo rows [2][64][72]
constexpr int kMaxDkBf16 = 512;   // the output block's q rows fit in smem
static_assert(kStage == 2 * kCT * kTS, "a stage holds 64 rows hi and lo");
// Row strides are an odd number of 16-byte units, so that the 8 rows one
// ldmatrix reads start in 8 distinct groups of 4 banks.

// wait until at most n of this thread's cp.async groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// nrows x ncols of the row-major bf16 matrix src (row stride ld) into
// shared rows of `stride` elements, by kThr threads (this one the
// first-th); rows at or past valid_r and columns at or past valid_c are
// zero.  vec: 16-byte cp.async (ncols, ld and every column offset
// multiples of 8, src 16-byte aligned); else element by element.
template <int kThr>
__device__ __forceinline__ void load_rows(bf16* dst, int stride,
                                          const bf16* src, long long ld,
                                          int nrows, int valid_r, int ncols,
                                          int valid_c, bool vec, int first) {
  if (vec) {
    const int chunks = ncols / 8;
    for (int e = first; e < nrows * chunks; e += kThr) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * 8;
      const bool full = r < valid_r && c < valid_c;
      cp_async16(smem_u32(dst + r * stride + c), full ? src + r * ld + c : src,
                 full);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = first; e < nrows * ncols; e += kThr) {
      const int r = e / ncols;
      const int c = e - r * ncols;
      dst[r * stride + c] = r < valid_r && c < valid_c ? src[r * ld + c]
                                                       : zero;
    }
  }
}

// (x0, x1) as two bf16 pairs: hi the values rounded, lo the rest rounded,
// so that hi + lo keeps 16 bits of the mantissa
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// x: a bf16 pair of an mma fragment, scaled by (f0, f1) and split
__device__ __forceinline__ void split_scaled(unsigned x, float f0, float f1,
                                             unsigned& hi, unsigned& lo) {
  split_pair(__uint_as_float(x << 16) * f0,
             __uint_as_float(x & 0xffff0000u) * f1, hi, lo);
}

constexpr int kStS = 40;          // bf16 row stride of a warp's staging

constexpr size_t walk_smem_bytes() {
  return 2 * 2 * size_t(kMaxL) * kTS * sizeof(bf16)   // k, v: two stages
         + size_t(kMmaWarps) * 2 * 16 * kStS * sizeof(bf16)  // staging
         + (4 * size_t(kMaxL) + 4) * sizeof(float);   // c, log_i; a and
                                                      // (decay, m'): two
                                                      // stages
}

// Pass 1.  Block (64 rows k0 of dk, 64 columns v0 of dv, bh): the walk.
// Warps 0-7 compute: warp w holds rows k0 + 16 (w % 4) .. + 15 and columns
// v0 + 32 (w / 4) .. + 31 of the tile, acc[j] its columns + 8 j .. + 7 in
// the accumulator layout; in the column-tile-0 blocks warps 0-3 also hold
// the same rows of n in nacc (every column of it alike).  Warp 8 feeds
// them: while they work on chunk j it loads chunk j + 1's k and v tiles
// and forms its gates, so that one barrier a chunk hands both over.
__global__ void __launch_bounds__(kWalkThreads, 2)
mlstm_state_walk_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const float* __restrict__ li,
                        const float* __restrict__ lf,
                        const float* __restrict__ C0,
                        const float* __restrict__ n0,
                        const float* __restrict__ m0, float* __restrict__ C1,
                        float* __restrict__ n1, float* __restrict__ m1,
                        bf16* __restrict__ chi, bf16* __restrict__ clo,
                        float* __restrict__ nbuf, float* __restrict__ m_in,
                        long long S, int dk, int dv, int L, int nc, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [2][kMaxL][kTS]
  bf16* vs = ks + 2 * kMaxL * kTS;                // [2][kMaxL][kTS]
  bf16* stg = vs + 2 * kMaxL * kTS;               // [kMmaWarps][2][16][kStS]
  float* cs = reinterpret_cast<float*>(stg + kMmaWarps * 2 * 16 * kStS);
  float* lis = cs + kMaxL;
  float* as = lis + kMaxL;                        // [2][kMaxL]: e^{w_s - m'}
  float* sc = as + 2 * kMaxL;                     // [2][2]: the decay, m'
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool feeder = warp == kMmaWarps;
  const int rw = warp & 3, cw = (warp >> 2) & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * kCT, v0 = blockIdx.y * kCT;
  const long long bh = blockIdx.z;
  const long long cells = static_cast<long long>(dk) * dv;
  const bool lead = blockIdx.x == 0 && blockIdx.y == 0;
  const bool with_n = blockIdx.y == 0 && cw == 0 && !feeder;
  const bool vec_ok = vec != 0;
  const int row0 = k0 + 16 * rw + g;              // rows row0, row0 + 8
  const int col0 = v0 + 32 * cw;                  // the warp's columns
  bf16* st_hi = stg + (warp % kMmaWarps) * 2 * 16 * kStS;   // [16][kStS]
  bf16* st_lo = st_hi + 16 * kStS;
  const bf16* kb = k + bh * S * dk + k0;
  const bf16* vb = v + bh * S * dv + v0;

  // the feeder's two jobs: chunk j's k and v tiles into stage `stage`,
  // and its gates from m (the m entering it) into stage `stage`
  const auto load = [&](int j, int stage) {
    const long long t0 = static_cast<long long>(j) * L;
    const int n = static_cast<int>(min(static_cast<long long>(L), S - t0));
    load_rows<32>(ks + stage * kMaxL * kTS, kTS, kb + t0 * dk, dk, kMaxL, n,
                  kCT, dk - k0, vec_ok, lane);
    load_rows<32>(vs + stage * kMaxL * kTS, kTS, vb + t0 * dv, dv, kMaxL, n,
                  kCT, dv - v0, vec_ok, lane);
    cp_async_commit();
  };
  const auto gates = [&](int j, int stage, float m) {
    const long long t0 = static_cast<long long>(j) * L;
    const int n = static_cast<int>(min(static_cast<long long>(L), S - t0));
    __syncwarp();
    warp_gates(li, lf, bh * S + t0, n, cs, lis, lane);
    __syncwarp();
    const float c_last = cs[n - 1];
    float mx = kNeg;
    for (int s = lane; s < n; s += 32) {
      mx = fmaxf(mx, (c_last - cs[s]) + lis[s]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(c_last + m, mx);
    float* a = as + stage * kMaxL;
    for (int s = lane; s < kMaxL; s += 32) {
      a[s] = s < n ? expf((c_last - cs[s]) + lis[s] - m_new) : 0.f;
    }
    if (lane == 0) {
      sc[2 * stage] = expf(c_last + m - m_new);
      sc[2 * stage + 1] = m_new;
    }
  };

  float acc[4][4], nacc[4];
  float m = m0[bh];                               // the feeder's: entering
  if (feeder) {
    load(0, 0);
    gates(0, 0, m);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = col0 + 8 * j + 2 * tg + (e & 1);
        acc[j][e] = row < dk && col < dv
                        ? C0[bh * cells + static_cast<long long>(row) * dv +
                             col]
                        : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1);
      nacc[e] = with_n && row < dk ? n0[bh * dk + row] : 0.f;
    }
  }

  // ldmatrix rows of this lane.  A = (a . k)^T (rows dk, columns steps)
  // from k stored by step, transposed: steps lane % 8 + 8 (lane / 16),
  // columns 16 rw + 8 (lane / 8 % 2).  B = v (steps x columns) likewise
  // transposed: steps lane % 8 + 8 (lane / 8 % 2), columns 32 cw + 8
  // (lane / 16).
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * kTS + 16 * rw +
                    8 * ((lane >> 3) & 1);
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kTS + 32 * cw +
                    8 * (lane >> 4);
  const unsigned ones = pack_bf16(1.f, 1.f);     // B of n = (a . k)^T 1

  for (int j = 0; j < nc; ++j) {
    const long long t0 = static_cast<long long>(j) * L;
    const int n = static_cast<int>(min(static_cast<long long>(L), S - t0));
    const long long z = bh * nc + j;
    const int stage = j & 1;
    if (feeder) cp_async_wait_all();
    __syncthreads();   // chunk j's k, v, a and decay are in; j - 1 is done
    if (feeder) {
      if (lead && lane == 0) m_in[z] = m;
      m = sc[2 * stage + 1];                      // the m entering j + 1
      if (j + 1 < nc) {
        load(j + 1, stage ^ 1);
        gates(j + 1, stage ^ 1, m);
      }
      continue;
    }

    // the state entering chunk j, for the output pass: hi and lo through
    // the warp's staging rows, so that each lane stores 16 bytes of a row
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned hi, lo;
        split_pair(acc[jj][2 * r], acc[jj][2 * r + 1], hi, lo);
        const int o = (g + 8 * r) * kStS + 8 * jj + 2 * tg;
        *reinterpret_cast<unsigned*>(st_hi + o) = hi;
        *reinterpret_cast<unsigned*>(st_lo + o) = lo;
      }
    }
    __syncwarp();
    if (vec_ok) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rr = (lane >> 2) + 8 * u, cc = 8 * (lane & 3);
        const int row = k0 + 16 * rw + rr, col = col0 + cc;
        if (row < dk && col < dv) {
          const long long o = z * cells + static_cast<long long>(row) * dv +
                              col;
          *reinterpret_cast<uint4*>(chi + o) =
              *reinterpret_cast<const uint4*>(st_hi + rr * kStS + cc);
          *reinterpret_cast<uint4*>(clo + o) =
              *reinterpret_cast<const uint4*>(st_lo + rr * kStS + cc);
        }
      }
    } else {
      for (int e = lane; e < 16 * 32; e += 32) {
        const int rr = e >> 5, cc = e & 31;
        const int row = k0 + 16 * rw + rr, col = col0 + cc;
        if (row < dk && col < dv) {
          const long long o = z * cells + static_cast<long long>(row) * dv +
                              col;
          chi[o] = st_hi[rr * kStS + cc];
          clo[o] = st_lo[rr * kStS + cc];
        }
      }
    }
    if (with_n && tg == 0) {
      if (row0 < dk) nbuf[z * dk + row0] = nacc[0];
      if (row0 + 8 < dk) nbuf[z * dk + row0 + 8] = nacc[2];
    }

    // C <- decay C + (a . k)^T v, n <- decay n + (a . k)^T 1
    const float decay = sc[2 * stage];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] *= decay;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) nacc[e] *= decay;
    const unsigned a_addr = smem_u32(ks + stage * kMaxL * kTS + a_off);
    const unsigned b_addr = smem_u32(vs + stage * kMaxL * kTS + b_off);
    const float* a_s = as + stage * kMaxL;
    const int steps = (n + 15) / 16;
#pragma unroll
    for (int st = 0; st < kMaxL / 16; ++st) {
      if (st >= steps) break;
      unsigned a[4], hi[4], lo[4], bv[2][4];
      ldmatrix_x4_trans(a, a_addr + st * 16 * kTS * 2);
      ldmatrix_x4_trans(bv[0], b_addr + st * 16 * kTS * 2);
      ldmatrix_x4_trans(bv[1], b_addr + st * 16 * kTS * 2 + 32);
      const float* w = a_s + 16 * st + 2 * tg;
      split_scaled(a[0], w[0], w[1], hi[0], lo[0]);
      split_scaled(a[1], w[0], w[1], hi[1], lo[1]);
      split_scaled(a[2], w[8], w[9], hi[2], lo[2]);
      split_scaled(a[3], w[8], w[9], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        mma_bf16(acc[2 * dp], hi, bv[dp][0], bv[dp][1]);
        mma_bf16(acc[2 * dp + 1], hi, bv[dp][2], bv[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        mma_bf16(acc[2 * dp], lo, bv[dp][0], bv[dp][1]);
        mma_bf16(acc[2 * dp + 1], lo, bv[dp][2], bv[dp][3]);
      }
      if (with_n) {
        mma_bf16(nacc, hi, ones, ones);
        mma_bf16(nacc, lo, ones, ones);
      }
    }
  }

  if (feeder) {
    if (lead && lane == 0) m1[bh] = m;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1);
      const int col = col0 + 8 * j + 2 * tg + (e & 1);
      if (row < dk && col < dv) {
        C1[bh * cells + static_cast<long long>(row) * dv + col] = acc[j][e];
      }
    }
  }
  if (with_n && tg == 0) {
    if (row0 < dk) n1[bh * dk + row0] = nacc[0];
    if (row0 + 8 < dk) n1[bh * dk + row0 + 8] = nacc[2];
  }
}

// bytes of the output block's shared memory for dk padded to dkp
inline size_t out_bf16_smem_bytes(int dkp) {
  return sizeof(bf16) * (size_t(kMaxL) * (dkp + 8)      // q
                         + size_t(kStages) * kStage     // the ring
                         + size_t(kMaxL) * kTS)         // a v tile
         + sizeof(float) * (2 * size_t(kMaxL) + dkp);   // c, log_i, n
}

// Pass 2.  Block z = bh * nc + j: chunk j, warp w its rows 16 w .. + 15.
// The ring carries first the k slices (64 columns of dk, all steps), then
// the C items i = (column tile i / ndk, dk rows 64 (i % ndk) ..), hi and lo;
// kStages - 1 of them are in flight while one is used.  Each column tile's
// v tile loads with its first C item.
__global__ void __launch_bounds__(kOutThreads, 1)
mlstm_chunk_out_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const float* __restrict__ li,
                            const float* __restrict__ lf,
                            const bf16* __restrict__ chi,
                            const bf16* __restrict__ clo,
                            const float* __restrict__ nbuf,
                            const float* __restrict__ m_in_buf,
                            bf16* __restrict__ h, long long S, int dk,
                            int dv, int L, int nc, float scale, int vec) {
  const long long z = blockIdx.x;
  const long long bh = z / nc, j = z % nc;
  const int n = static_cast<int>(min(static_cast<long long>(L), S - j * L));
  const int dkp = (dk + kCT - 1) / kCT * kCT;
  const int qstride = dkp + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kMaxL][qstride]
  bf16* ring = qs + kMaxL * qstride;              // [kStages][kStage]
  bf16* vs = ring + kStages * kStage;             // [kMaxL][kTS]
  float* cs = reinterpret_cast<float*>(vs + kMaxL * kTS);
  float* lis = cs + kMaxL;
  float* nsh = lis + kMaxL;                       // [dkp]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const long long t0 = bh * S + j * L;            // the chunk's first step
  const long long cells = static_cast<long long>(dk) * dv;
  const bool vec_ok = vec != 0;
  const bool busy = 16 * warp < n;                // the warp has live rows
  const int ndk = dkp / kCT;

  chunk_gates(li, lf, t0, n, cs, lis);
  const float m_in = m_in_buf[z];
  for (int i = tid; i < dkp; i += kOutThreads) {
    nsh[i] = i < dk ? nbuf[z * dk + i] : 0.f;
  }
  load_rows<kOutThreads>(qs, qstride, q + t0 * dk, dk, kMaxL, n, dkp, dk,
                         vec_ok, tid);
  const bf16* kc = k + t0 * dk;
  const auto load_k = [&](int d) {
    load_rows<kOutThreads>(ring + (d % kStages) * kStage, kTS, kc + d * kCT,
                           dk, kMaxL, n, kCT, dk - d * kCT, vec_ok, tid);
  };
#pragma unroll
  for (int d = 0; d < kStages - 1; ++d) {
    if (d < ndk) load_k(d);
    cp_async_commit();   // group d: slice d (and q with slice 0)
  }

  // ldmatrix rows of this lane: q (A) rows lane % 16, columns 8 (lane /
  // 16); k (B, two 8-step tiles) steps lane % 8 + 8 (lane / 16), columns
  // 8 (lane / 8 % 2); C rows and v (B, transposed) rows lane % 8 + 8
  // (lane / 8 % 2), columns 8 (lane / 16).
  const unsigned q_addr = smem_u32(qs + (16 * warp + (lane & 15)) * qstride +
                                   8 * (lane >> 4));
  const int k_off = ((lane & 7) + 8 * (lane >> 4)) * kTS +
                    8 * ((lane >> 3) & 1);
  const int t_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kTS +
                    8 * (lane >> 4);

  // S = q k^T: 16 rows x 128 steps a warp, the tiles at or below its rows
  float s[16][4];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
  for (int d = 0; d < ndk; ++d) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice d is in; every warp is done with slice d - 1
    if (d + kStages - 1 < ndk) load_k(d + kStages - 1);
    cp_async_commit();
    if (!busy) continue;
    const unsigned k_addr = smem_u32(ring + (d % kStages) * kStage + k_off);
#pragma unroll
    for (int st = 0; st < kCT / 16; ++st) {
      unsigned a[4];
      ldmatrix_x4(a, q_addr + (d * kCT + st * 16) * 2);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (np <= warp) {
          unsigned bk[4];
          ldmatrix_x4(bk, k_addr + np * 16 * kTS * 2 + st * 32);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with the k slices

  // C item i: 64 rows of dk (hi, then lo) of column tile i / ndk
  const bf16* chi_z = chi + z * cells;
  const bf16* clo_z = clo + z * cells;
  const int nvt = (dv + kCT - 1) / kCT;
  const int total = nvt * ndk;
  const auto load_c = [&](int i) {
    const int vt = i / ndk, d = i - vt * ndk;
    bf16* dst = ring + (i % kStages) * kStage;
    const long long o = static_cast<long long>(d) * kCT * dv + vt * kCT;
    load_rows<kOutThreads>(dst, kTS, chi_z + o, dv, kCT, dk - d * kCT, kCT,
                           dv - vt * kCT, vec_ok, tid);
    load_rows<kOutThreads>(dst + kCT * kTS, kTS, clo_z + o, dv, kCT,
                           dk - d * kCT, kCT, dv - vt * kCT, vec_ok, tid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load_c(i);
    cp_async_commit();
  }

  // the rows' statistics and P, in place of S
  float carry[2], den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 16 * warp + g + 8 * r;
    const bool live = t < n;
    float qn = 0.f;
    for (int i = tg; i < dkp; i += 4) {
      qn = fmaf(__bfloat162float(qs[t * qstride + i]), nsh[i], qn);
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    const float ct = live ? cs[t] : 0.f;
    float mx = kNeg;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sx = 8 * jj + 2 * tg + e;
        if (live && sx <= t) mx = fmaxf(mx, (ct - cs[sx]) + lis[sx]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_inter = ct + m_in;
    const float m_t = fmaxf(mx, m_inter);
    carry[r] = expf(m_inter - m_t);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sx = 8 * jj + 2 * tg + e;
        float p = 0.f;
        if (live && sx <= t) {
          p = s[jj][2 * r + e] * scale * expf((ct - cs[sx]) + lis[sx] - m_t);
        }
        s[jj][2 * r + e] = p;
        rs += p;
      }
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    den[r] = fmaxf(fabsf(rs + carry[r] * (qn * scale)), expf(-m_t));
    carry[r] *= scale;                            // h's factor of q C
  }
  // P as the A operand of P v, 16 steps a fragment, split hi + lo
  unsigned ph[8][4], pl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    split_pair(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
    split_pair(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
    split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
    split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
  }

  // per 64 columns of h: acc = carry dk^-1/2 q C (hi + lo) over dk, then
  // acc += P v (hi + lo), h = acc / den
  const unsigned v_addr = smem_u32(vs + t_off);
  const bf16* vc = v + t0 * dv;
  for (int vt = 0; vt < nvt; ++vt) {
    float acc[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
    }
    for (int d = 0; d < ndk; ++d) {
      const int i = vt * ndk + d;
      cp_async_wait<kStages - 2>();
      __syncthreads();   // item i is in; every warp is done with item i - 1
      if (d == 0) {      // and with the v tile and h of column tile vt - 1
        load_rows<kOutThreads>(vs, kTS, vc + vt * kCT, dv, kMaxL, n, kCT,
                               dv - vt * kCT, vec_ok, tid);
      }
      if (i + kStages - 1 < total) load_c(i + kStages - 1);
      cp_async_commit();
      if (!busy) continue;
      const unsigned c_addr = smem_u32(ring + (i % kStages) * kStage + t_off);
#pragma unroll
      for (int st = 0; st < kCT / 16; ++st) {
        unsigned a[4];
        ldmatrix_x4(a, q_addr + (d * kCT + st * 16) * 2);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          unsigned bh_[4], bl[4];
          ldmatrix_x4_trans(bh_, c_addr + st * 16 * kTS * 2 + dp * 32);
          ldmatrix_x4_trans(bl, c_addr + (kCT + st * 16) * kTS * 2 + dp * 32);
          mma_bf16(acc[2 * dp], a, bh_[0], bh_[1]);
          mma_bf16(acc[2 * dp], a, bl[0], bl[1]);
          mma_bf16(acc[2 * dp + 1], a, bh_[2], bh_[3]);
          mma_bf16(acc[2 * dp + 1], a, bl[2], bl[3]);
        }
      }
    }
    // the v tile went out with item vt ndk + kStages - 1's group; the
    // waits of kStages - 1 more items cover it, else wait here
    if (ndk < kStages) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (busy) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] *= carry[e >> 1];
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk <= warp) {
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            unsigned bv[4];
            ldmatrix_x4_trans(bv, v_addr + kk * 16 * kTS * 2 + dp * 32);
            mma_bf16(acc[2 * dp], ph[kk], bv[0], bv[1]);
            mma_bf16(acc[2 * dp], pl[kk], bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], ph[kk], bv[2], bv[3]);
            mma_bf16(acc[2 * dp + 1], pl[kk], bv[2], bv[3]);
          }
        }
      }
    }
    // h = acc / den through the warp's own 16 rows of the v tile, which
    // every warp is done with, so that each lane stores 16 bytes of a row
    __syncthreads();
    if (!busy) continue;
    bf16* stg = vs + 16 * warp * kTS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / den[r];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        *reinterpret_cast<unsigned*>(stg + (g + 8 * r) * kTS + 8 * jj +
                                     2 * tg) =
            pack_bf16(acc[jj][2 * r] * inv, acc[jj][2 * r + 1] * inv);
      }
    }
    __syncwarp();
    if (vec_ok) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = (lane >> 3) + 4 * u, cc = 8 * (lane & 7);
        const int t = 16 * warp + rr, col = vt * kCT + cc;
        if (t < n && col < dv) {
          *reinterpret_cast<uint4*>(h + (t0 + t) * dv + col) =
              *reinterpret_cast<const uint4*>(stg + rr * kTS + cc);
        }
      }
    } else {
      for (int e = lane; e < 16 * kCT; e += 32) {
        const int rr = e / kCT, cc = e - rr * kCT;
        const int t = 16 * warp + rr, col = vt * kCT + cc;
        if (t < n && col < dv) h[(t0 + t) * dv + col] = stg[rr * kTS + cc];
      }
    }
  }
}

// The CUDA-core passes, for q, k, v of type T.
template <typename T>
int launch_cuda_cores(const void* q, const void* k, const void* v,
                      const float* li, const float* lf, const float* C0,
                      const float* n0, const float* m0, void* h, float* C1,
                      float* n1, float* m1, float* cbuf, float* nbuf,
                      float* sbuf, long long BH, long long S, int dk, int dv,
                      int L, float scale, cudaStream_t stream) {
  const int nc = static_cast<int>((S + L - 1) / L);
  const unsigned chunks = static_cast<unsigned>(BH * nc);
  const size_t smem = out_smem_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 g1(chunks, (dk + kTile - 1) / kTile, (dv + kTile - 1) / kTile);
  chunk_state_kernel<T><<<g1, kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), li, lf, cbuf, nbuf,
      sbuf, BH, S, dk, dv, L, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long cells = static_cast<long long>(dk) * dv + dk;
  const dim3 g2(static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                static_cast<unsigned>(BH));
  state_scan_kernel<<<g2, kThreads, 0, stream>>>(C0, n0, m0, C1, n1, m1,
                                                 cbuf, nbuf, sbuf, BH, dk,
                                                 dv, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 g3(chunks, (dv + kBV - 1) / kBV);
  chunk_out_kernel<T><<<g3, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), li, lf, cbuf, nbuf, sbuf,
      static_cast<T*>(h), BH, S, dk, dv, L, nc, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, const float* li,
                const float* lf, const float* C0, const float* n0,
                const float* m0, void* h, float* C1, float* n1, float* m1,
                float* cbuf, float* nbuf, float* sbuf, long long BH,
                long long S, int dk, int dv, int L, float scale,
                cudaStream_t stream) {
  if (dk > kMaxDkBf16) {   // the output pass keeps a chunk's q rows in smem
    return launch_cuda_cores<bf16>(q, k, v, li, lf, C0, n0, m0, h, C1, n1,
                                   m1, cbuf, nbuf, sbuf, BH, S, dk, dv, L,
                                   scale, stream);
  }
  const int nc = static_cast<int>((S + L - 1) / L);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const int vec = dk % 8 == 0 && dv % 8 == 0 &&
                  ((addr(q) | addr(k) | addr(v) | addr(h) | addr(cbuf)) &
                   15) == 0;
  // the scratch's states as two bf16 planes, hi then lo; the entering m is
  // sbuf's third plane, as the float32 route leaves it
  bf16* chi = reinterpret_cast<bf16*>(cbuf);
  bf16* clo = chi + BH * nc * static_cast<long long>(dk) * dv;
  float* m_in = sbuf + 2 * BH * nc;

  const size_t walk_smem = walk_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(walk_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dkp = (dk + kCT - 1) / kCT * kCT;
  const size_t out_smem = out_bf16_smem_bytes(dkp);
  err = cudaFuncSetAttribute(mlstm_chunk_out_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(out_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 g1((dk + kCT - 1) / kCT, (dv + kCT - 1) / kCT,
                static_cast<unsigned>(BH));
  mlstm_state_walk_kernel<<<g1, kWalkThreads, walk_smem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), li, lf, C0,
      n0, m0, C1, n1, m1, chi, clo, nbuf, m_in, S, dk, dv, L, nc, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  mlstm_chunk_out_bf16_kernel<<<static_cast<unsigned>(BH * nc), kOutThreads,
                                out_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), li, lf, chi, clo, nbuf, m_in,
      static_cast<bf16*>(h), S, dk, dv, L, nc, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long BH, long long S, long long dk, long long dv,
               long long L) {
  return BH < 1 || S < 1 || dk < 1 || dv < 1 || L < 1 || L > kMaxL;
}

}  // namespace

extern "C" {

// q, k: (BH, S, dk); v, h: (BH, S, dv); log_i, log_f: (BH, S) float32;
// C0, C1: (BH, dk, dv), n0, n1: (BH, dk), m0, m1: (BH) float32; all
// contiguous.  q, k, v, h of the entry's dtype.  Scratch: cbuf (BH, nc,
// dk, dv) elements of 4 bytes (float32 states on the float32 route, two
// bf16 planes hi and lo on the bf16 route), nbuf (BH, nc, dk) and sbuf
// (3, BH, nc) float32, nc = ceil(S / L).  1 <= L <= 128, S >= 1; scale =
// dk^-1/2.

int mlstm_f32(const void* q, const void* k, const void* v,
              const void* log_i, const void* log_f, const void* C0,
              const void* n0, const void* m0, void* h, void* C1, void* n1,
              void* m1, void* cbuf, void* nbuf, void* sbuf, long long BH,
              long long S, long long dk, long long dv, long long L,
              float scale, void* stream) {
  if (bad_shape(BH, S, dk, dv, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  return launch_cuda_cores<float>(
      q, k, v, f(log_i), f(log_f), f(C0), f(n0), f(m0), h, w(C1), w(n1),
      w(m1), w(cbuf), w(nbuf), w(sbuf), BH, S, static_cast<int>(dk),
      static_cast<int>(dv), static_cast<int>(L), scale, as_stream(stream));
}

int mlstm_bf16(const void* q, const void* k, const void* v,
               const void* log_i, const void* log_f, const void* C0,
               const void* n0, const void* m0, void* h, void* C1, void* n1,
               void* m1, void* cbuf, void* nbuf, void* sbuf, long long BH,
               long long S, long long dk, long long dv, long long L,
               float scale, void* stream) {
  if (bad_shape(BH, S, dk, dv, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  return launch_bf16(q, k, v, f(log_i), f(log_f), f(C0), f(n0), f(m0), h,
                     w(C1), w(n1), w(m1), w(cbuf), w(nbuf), w(sbuf), BH, S,
                     static_cast<int>(dk), static_cast<int>(dv),
                     static_cast<int>(L), scale, as_stream(stream));
}

}  // extern "C"
