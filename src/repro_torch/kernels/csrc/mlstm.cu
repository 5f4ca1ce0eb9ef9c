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
// The bf16 route, two kernels on wgmma and TMA, warp-specialised (the
// Hopper machinery of hopper_bf16.cuh).  Every product with a float32
// operand (the state C, the hand-off's scaled keys a . k, P and, for q .
// n, n) is taken as a bf16 pair hi + lo (hi the rounded value, lo the
// rounded rest: 16 bits of mantissa, where TF32 keeps 11 in the
// tensor-core time of two bf16 products; P rounded to bf16 alone misses
// the spec's 2e-3 on h at dk = 512, tests/test_torch_mlstm.py emulates
// both).  So the tensor cores do 30.6 GFLOP at the path's shape, 0.031 ms
// at the bf16 peak; the scratch is written once by pass 1 and read once
// by pass 2, 201.7 MB, 0.060 ms at 3.35 TB/s, and does not fit the 50 MB
// L2: the two passes cannot go below about 0.078 ms with all they move.
//   1. mlstm_state_walk_wgmma_kernel: one block per (64 rows of dk, 128
//      columns of dv, batch x head), 128 at the path's shape, one an SM,
//      384 threads.  A consumer warpgroup keeps its tile of C in wgmma
//      accumulators across the chunks.  Per chunk it writes the entering
//      tile as hi and lo bf16 planes into a 128-byte swizzled staging
//      buffer, each warp hands one 64 x 64 panel to a TMA store, it scales
//      the tile by the decay e^{c_L + m - m'} and adds (a . k)^T v as 16
//      wgmma SS products, A = (a . k)^T read transposed from shared memory
//      (m64n128k16, both operands MN-major).  Two producer warpgroups ready
//      the chunks ahead in three stages: three threads TMA-load chunk j +
//      2's k and v panels and its log_f and log_i (1-d maps, into the lo
//      plane's place until the split), one warp forms chunk j's gates in
//      registers (the cumsum of log f, a_s = e^{w_s - m'}, the new m)
//      while 224 threads scale chunk j - 1's k panel by a_s and split it
//      hi + lo in place, summing a . k in float for n, which the gate warp
//      carries.  Its floor is its 100.9 MB of stores, 0.030 ms; on an
//      NVIDIA H100 80GB HBM3 at 700 W it runs at about 0.057 ms, a chunk
//      every 3,000 clocks, its consumer's staging (1,300, a TMA store's
//      issue 350-500 of it) and products (1,250) in series.
//   2. mlstm_chunk_out_wgmma_kernel: one block per chunk (96 at the path's
//      shape, one an SM: q's 128 rows take 128 KB of shared memory at dk =
//      512 and a ring of five 16 KB stages most of the rest), a producer
//      warpgroup (one thread issues every TMA load, each q panel ahead of
//      the k panel S needs with it; setmaxnreg hands its registers to the
//      consumers) and two consumer warpgroups of 64 rows.  S = q k^T as
//      wgmma SS over dk; q . n as m64n8 products of q with n's hi and lo
//      rows; the decay, the rows' max, the carry and the denominator
//      max(|rowsum P + carry q . n|, e^{-m_t}) from the accumulators (exp2
//      on the MUFU; consumer 0's rows over their 64 keys alone); P stays in
//      registers as the hi + lo A operands of P v.  Then per 128 columns of
//      h: acc = q C_hi + q C_lo over dk (wgmma SS, 32-row items of the
//      scratch's planes by TMA, C transposed by its descriptor), acc *=
//      carry dk^-1/2, acc += P v (wgmma RS, v's two 64-column halves into
//      the accumulator's halves), and h = acc / den stored from the
//      registers.  Each chunk's C is read once: a block a chunk and 96 SMs,
//      where two blocks a chunk would read it twice or form S twice and
//      still leave 1.45 waves on 132 SMs.  Its floor is its 145 MB of
//      scratch, q, k, v and h, 0.043 ms; it runs at about 0.067 ms (the
//      same card), its C items at the device memory's rate but its start
//      (q and k for S) and its statistics with the ring full and the
//      memory idle.  Its q rows
//      in shared memory bound dk at 512 (the served head dim); a wider head
//      runs the CUDA-core passes below in bf16.
// The tensor maps zero-fill reads past S, dk and dv and drop stores past
// them, so a ragged last chunk, a chunk below 128 and head dims that fill
// no tile need no padding loops; the maps need rows of a multiple of 16
// bytes on 16-byte aligned bases, which the wrapper provides (ops.py pads
// q and k to a multiple of 8 columns, v likewise, copies a gate or
// operand off 16-byte alignment, and the scratch's planes have rows of dv
// rounded up to 8).  Steps past a chunk's end load (its neighbour's data
// or zeros) and meet a_s = 0 in the walk and P = 0 in the output pass.
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
// states (BH, nc, dk, dv) of 4 bytes (dv rounded up to a multiple of 8 on
// the wgmma route), the n (BH, nc, dk) and three scalars per chunk, all
// float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_bf16.cuh"

namespace {

constexpr int kMaxL = 128;       // largest chunk
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
// shuffle scan of the lanes.  gate_inputs loads lane l's steps (zeros past
// n), warp_gates_from forms the gates from them.
__device__ __forceinline__ void gate_inputs(const float* __restrict__ li,
                                            const float* __restrict__ lf,
                                            long long base, int n,
                                            float (&f)[4], float (&i)[4],
                                            int lane) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    f[u] = t < n ? lf[base + t] : 0.f;
    i[u] = t < n ? li[base + t] : 0.f;
  }
}
// c: the inclusive cumsum of the warp's log_f at lane l's steps 4 l ..
// 4 l + 3 (f, zeros past the chunk's end)
__device__ __forceinline__ void lane_cumsum(const float (&f)[4],
                                            float (&c)[4], int lane) {
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    run += f[u];
    c[u] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) c[u] = excl + c[u];
}
__device__ void warp_gates_from(const float (&f)[4], const float (&i)[4],
                                int n, float* cs, float* lis, int lane) {
  float c[4];
  lane_cumsum(f, c, lane);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    if (t < n) {
      cs[t] = c[u];
      lis[t] = i[u];
    }
  }
}
__device__ void warp_gates(const float* __restrict__ li,
                           const float* __restrict__ lf, long long base,
                           int n, float* cs, float* lis, int lane) {
  float f[4], i[4];
  gate_inputs(li, lf, base, n, f, i, lane);
  warp_gates_from(f, i, n, cs, lis, lane);
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
// bf16 route: wgmma, TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                     // threads of a warpgroup
constexpr int kRowBytes = 128;               // a swizzled row: 64 bf16
constexpr int kPanel = kMaxL * kRowBytes;    // 64 columns by 128 rows
constexpr int kCPanel = 64 * kRowBytes;      // 64 columns by 64 rows of C
constexpr int kMaxDkWgmma = 512;   // the output block's q rows fit in smem
constexpr int kSmemMax = 232448;   // shared memory a block can have

// (x0, x1) as two bf16 pairs: hi the values rounded, lo the rest rounded,
// so that hi + lo keeps 16 bits of the mantissa
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// -- pass 1: the state walk ---------------------------------------------------

constexpr int kWalkCols = 128;           // columns of C a walk block holds
constexpr int kWalkThreads = 3 * kWg;    // a consumer, a producer of two
constexpr int kSplitters = kWalkThreads - kWg - 32;   // its splitting threads
constexpr int kWalkStages = 3;
// log_f and log_i of a chunk come in boxes of 132 elements from a 16-byte
// boundary (a box's start in device memory must be aligned, the chunk's
// first step need not be), each into 640 bytes of shared memory (a TMA
// destination is 128-byte aligned)
constexpr int kGateBox = kMaxL + 4;
constexpr int kGateSlot = 640;

// The walk block's shared memory: kWalkStages stages of chunk j (its k
// panel, 64 columns of dk by 128 steps, scaled in place into the hi plane
// of a . k; the lo plane; v's panels, 128 columns of dv), the staging
// buffer of the entering C tile (hi, then lo, 64 x 64 panels), the
// producer's a_s = e^{w_s - m'}, its splitting warps' column sums of a . k,
// each stage's decay, then each stage's loaded, full and empty barriers.
// The dynamic base is 1024-aligned (checked), so the plan keeps no slack.
struct WalkPlan {
  static constexpr int kStageBytes = 4 * kPanel;
  static constexpr int kStagingOffset = kWalkStages * kStageBytes;
  static constexpr int kGateOffset = kStagingOffset + 4 * kCPanel;
  static constexpr int kSumOffset = kGateOffset + kMaxL * 4;
  static constexpr int kDecayOffset = kSumOffset + kSplitters / 32 * 64 * 4;
  static constexpr int kBarOffset = kDecayOffset + 8 * kWalkStages;
  static constexpr int kSmem = kBarOffset + 8 * 3 * kWalkStages;
};
static_assert(WalkPlan::kSmem <= kSmemMax, "the walk's plan fits");

// Chunk j's gates from its log_f and log_i in shared memory (lf, li from
// its first step; lane l takes steps 4 l .. 4 l + 3, those past its n
// steps as zeros) and the m
// entering it: a_s = e^{w_s - m'} of the lane's steps (zero past n), w_s =
// (c_last - c_s) + log_i_s with c the inclusive cumsum of log_f; the decay
// e^{c_last + m - m'}; m'.  The cumsum in warp_gates' order, so the same
// bits as the output pass's.
__device__ __forceinline__ void lane_gates(const float* lf, const float* li,
                                           int n, float m, int lane,
                                           float (&a)[4], float& decay,
                                           float& m_new) {
  float f[4], i[4], c[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool live = 4 * lane + u < n;
    f[u] = live ? lf[4 * lane + u] : 0.f;
    i[u] = live ? li[4 * lane + u] : 0.f;
  }
  lane_cumsum(f, c, lane);
  const int last = (n - 1) & 3;
  const float mine = last == 0 ? c[0] : last == 1 ? c[1] : last == 2 ? c[2]
                                                                    : c[3];
  const float c_last = __shfl_sync(0xffffffffu, mine, (n - 1) >> 2);
  float w[4];
  float mx = kNeg;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    w[u] = (c_last - c[u]) + i[u];
    if (4 * lane + u < n) mx = fmaxf(mx, w[u]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  m_new = fmaxf(c_last + m, mx);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a[u] = 4 * lane + u < n ? expf(w[u] - m_new) : 0.f;
  }
  decay = expf(c_last + m - m_new);
}

// Block (64 rows k0 of dk, 128 columns v0 of dv, bh).  Warpgroup 0, the
// consumer, holds the tile of C in wgmma accumulators: acc[4 j + e] is row
// k0 + 16 warp + g + 8 (e / 2), column v0 + 8 j + 2 tg + (e % 2).  Per
// chunk it writes the entering tile to the scratch (hi and lo through the
// staging buffer, then a TMA store that runs on under the products), then
// C <- decay C + (a . k)^T v as 16 wgmma SS products, A = (a . k)^T the hi
// and lo planes read transposed by their descriptors, B = v (transposed).
// Warpgroups 1 and 2, the producer, ready the chunks ahead: three threads
// TMA-load chunk j + 2's k, v, log_f and log_i (these two into the lo
// plane's place, free until the split) as soon as its stage is free, its
// warp 0 forms chunk j's gates in registers while warps 1-7 scale chunk j -
// 1's k panel by its a_s and split it into the planes in place, summing a .
// k over the steps as they go; warp 0 then carries n <- decay n + those
// sums (lane l its rows k0 + 2 l, + 1; the column-tile-0 blocks store it).
// The gate inputs come by TMA and not by loads of the warp's own: a
// barrier after a thread's loads waits for them, and would put their
// latency on the producer's path every chunk.
__global__ void __launch_bounds__(kWalkThreads, 1)
mlstm_state_walk_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_hi,
                              const __grid_constant__ CUtensorMap tm_lo,
                              const __grid_constant__ CUtensorMap tm_li,
                              const __grid_constant__ CUtensorMap tm_lf,
                              const float* __restrict__ C0,
                              const float* __restrict__ n0,
                              const float* __restrict__ m0,
                              float* __restrict__ C1, float* __restrict__ n1,
                              float* __restrict__ m1,
                              float* __restrict__ nbuf,
                              float* __restrict__ m_in, long long S, int dk,
                              int dv, int L, int nc) {
  using P = WalkPlan;
  extern __shared__ __align__(1024) unsigned char walk_smem[];
  unsigned char* smem = walk_smem;
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();   // the swizzled panels need 1024-byte rows
  float* a_s = reinterpret_cast<float*>(smem + P::kGateOffset);
  float* sums = reinterpret_cast<float*>(smem + P::kSumOffset);
  float* decays = reinterpret_cast<float*>(smem + P::kDecayOffset);
  const uint32_t bar0 = base + P::kBarOffset;
  // stage s's barriers: its k and v landed, its planes formed, its reads
  // done
  const auto loaded = [&](int s) { return bar0 + 8 * s; };
  const auto full = [&](int s) { return bar0 + 8 * (kWalkStages + s); };
  const auto empty = [&](int s) {
    return bar0 + 8 * (2 * kWalkStages + s);
  };
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 64, v0 = blockIdx.y * kWalkCols;
  const int bh = blockIdx.z;
  const int vpanels = v0 + 64 < dv ? 2 : 1;    // v's panels in bounds
  const bool lead = blockIdx.x == 0 && blockIdx.y == 0;

  if (tid == 0) {
    prefetch_tensor_map(&tm_k);
    prefetch_tensor_map(&tm_v);
    prefetch_tensor_map(&tm_hi);
    prefetch_tensor_map(&tm_lo);
    prefetch_tensor_map(&tm_li);
    prefetch_tensor_map(&tm_lf);
    for (int s = 0; s < kWalkStages; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(full(s), kSplitters);   // each splitting thread
      mbar_init(empty(s), 4);    // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWg) {
    // -- the producer: warp 0 forms each chunk's gates while warps 1-3
    // split the chunk before it; thread 32 issues the loads
    const int ptid = tid - kWg;
    // chunk j's k, v, log_f and log_i into its stage, once the consumer has
    // freed it: the first lanes of splitting warps bw = 1-3 issue them, bw
    // = 1 with the stage's expected bytes
    const int bw = ptid >> 5;
    const auto load = [&](int j) {
      const int s = j % kWalkStages;
      mbar_wait(empty(s), ((j / kWalkStages) & 1) ^ 1);
      const uint32_t sa = base + s * P::kStageBytes;
      const int t0 = j * L;
      // log_f and log_i from the 16-byte boundary at or below the chunk's
      // first step
      const int g0 = (bh * static_cast<int>(S) + t0) & ~3;
      if (bw == 1) {
        mbar_arrive_expect_tx(loaded(s),
                              (1 + vpanels) * kPanel + 2 * kGateBox * 4);
        tma_load_3d(sa, &tm_k, k0, t0, bh, loaded(s));
        tma_load_1d(sa + kPanel, &tm_lf, g0, loaded(s));
      } else if (bw == 2) {
        tma_load_3d(sa + 2 * kPanel, &tm_v, v0, t0, bh, loaded(s));
        tma_load_1d(sa + kPanel + kGateSlot, &tm_li, g0, loaded(s));
      } else if (vpanels == 2) {
        tma_load_3d(sa + 3 * kPanel, &tm_v, v0 + 64, t0, bh, loaded(s));
      }
    };
    if (ptid < 32) {
      const bool with_n = blockIdx.y == 0;
      float m = m0[bh];
      float n_r[2], decay_prev = 0.f;   // n's rows k0 + 2 ptid, + 1
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = k0 + 2 * ptid + x;
        n_r[x] = row < dk ? n0[static_cast<long long>(bh) * dk + row] : 0.f;
      }
      // n <- decay n + the column sums of chunk j - 1 (its planes formed);
      // store the n entering chunk z (or the final n where z < 0)
      const auto carry_n = [&](bool add, long long z) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = 2 * ptid + x;
          if (add) {
            float u = 0.f;
#pragma unroll
            for (int w = 0; w < kSplitters / 32; ++w) u += sums[64 * w + col];
            n_r[x] = decay_prev * n_r[x] + u;
          }
          const int row = k0 + col;
          if (with_n && row < dk) {
            if (z >= 0) {
              nbuf[z * dk + row] = n_r[x];
            } else {
              n1[static_cast<long long>(bh) * dk + row] = n_r[x];
            }
          }
        }
      };
      for (int j = 0; j < nc; ++j) {
        const int s = j % kWalkStages;
        const int n = static_cast<int>(
            min(static_cast<long long>(L), S - static_cast<long long>(j) * L));
        mbar_wait(loaded(s), (j / kWalkStages) & 1);
        const float* lfs =
            reinterpret_cast<const float*>(smem + s * P::kStageBytes +
                                           kPanel) +
            ((bh * static_cast<int>(S) + j * L) & 3);
        float a[4], decay, m_new;
        lane_gates(lfs, lfs + kGateSlot / 4, n, m, ptid, a, decay, m_new);
        // a_s and the sums of chunk j - 1 are read once its planes are
        // formed
        if (j > 0) {
          mbar_wait(full((j - 1) % kWalkStages),
                    ((j - 1) / kWalkStages) & 1);
        }
        carry_n(j > 0, static_cast<long long>(bh) * nc + j);
        *reinterpret_cast<float4*>(a_s + 4 * ptid) =
            make_float4(a[0], a[1], a[2], a[3]);
        if (ptid == 0) {
          decays[s] = decay;
          if (lead) m_in[bh * nc + j] = m;
        }
        m = m_new;
        decay_prev = decay;
        named_arrive(2, 32 + kSplitters);   // a_s is in, log_f, log_i read
      }
      mbar_wait(full((nc - 1) % kWalkStages), ((nc - 1) / kWalkStages) & 1);
      carry_n(true, -1);
      if (lead && ptid == 0) m1[bh] = m;
      return;
    }
    const bool loader = (ptid & 31) == 0 && bw <= 3;
    if (loader) {
      for (int j = 0; j < kWalkStages - 1 && j < nc; ++j) load(j);
    }
    for (int j = 0; j < nc; ++j) {
      const int s = j % kWalkStages;
      unsigned char* st = smem + s * P::kStageBytes;
      named_sync(2, 32 + kSplitters);
      mbar_wait(loaded(s), (j / kWalkStages) & 1);
      // the k panel, scaled by a_s row by row, into the hi plane in place
      // and the lo plane beside it, the swizzle alike in all three: thread
      // t takes the 16 bytes of dk columns 8 (t % 8) .. of steps t / 8 + 28
      // i, summing a . k for each of those columns in step order; then the
      // sums of a warp's four threads of a column (lanes ^ 8, ^ 16)
      const int t8 = (ptid - 32) & 7;
      float u[8] = {};
#pragma unroll 2
      for (int r = (ptid - 32) >> 3; r < kMaxL; r += kSplitters / 8) {
        const int off = r * kRowBytes + ((t8 ^ (r & 7)) << 4);
        const float w = a_s[r];
        uint4 x = *reinterpret_cast<const uint4*>(st + off);
        uint32_t* xs = reinterpret_cast<uint32_t*>(&x);
        uint4 lo;
        uint32_t* ls = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float f0 = __uint_as_float(xs[q] << 16) * w;
          const float f1 = __uint_as_float(xs[q] & 0xffff0000u) * w;
          split_pair(f0, f1, xs[q], ls[q]);
          u[2 * q] += f0;
          u[2 * q + 1] += f1;
        }
        *reinterpret_cast<uint4*>(st + off) = x;
        *reinterpret_cast<uint4*>(st + kPanel + off) = lo;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        u[q] += __shfl_xor_sync(0xffffffffu, u[q], 8);
        u[q] += __shfl_xor_sync(0xffffffffu, u[q], 16);
      }
      if ((ptid & 31) < 8) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          sums[64 * ((ptid - 32) >> 5) + 8 * t8 + q] = u[q];
        }
      }
      fence_proxy_async();
      mbar_arrive(full(s));
      if (loader && j + kWalkStages - 1 < nc) load(j + kWalkStages - 1);
    }
    return;
  }

  // -- the consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long long cells = static_cast<long long>(dk) * dv;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + 16 * warp + g + 8 * (e >> 1);
      const int col = v0 + 8 * j + 2 * tg + (e & 1);
      acc[4 * j + e] = row < dk && col < dv
                           ? C0[bh * cells + static_cast<long long>(row) * dv +
                                col]
                           : 0.f;
    }
  }
  unsigned char* stg = smem + P::kStagingOffset;

  for (int j = 0; j < nc; ++j) {
    const int s = j % kWalkStages;
    const int z = bh * nc + j;
    // the state entering chunk j, hi and lo, into the staging buffer once
    // the stores of chunk j - 1 have read it, then by TMA into the scratch:
    // warp w's first lane stores panel w (hi 0, hi 1, lo 0, lo 1)
    if (lane == 0) bulk_wait_read<0>();
    named_sync(1, kWg);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const int off = (jj >> 3) * kCPanel + r * kRowBytes +
                        (((jj & 7) ^ (r & 7)) << 4) + 4 * tg;
        uint32_t hi, lo;
        split_pair(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(stg + off) = hi;
        *reinterpret_cast<uint32_t*>(stg + 2 * kCPanel + off) = lo;
      }
    }
    fence_proxy_async();
    named_sync(1, kWg);
    if (lane == 0 && (warp & 1) < vpanels) {
      tma_store_3d(warp < 2 ? &tm_hi : &tm_lo,
                   smem_addr(stg) + warp * kCPanel, v0 + 64 * (warp & 1), k0,
                   z);
      bulk_commit();
    }

    // C <- decay C + (a . k)^T v
    mbar_wait(full(s), (j / kWalkStages) & 1);
    const float decay = decays[s];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= decay;
    const uint32_t st = base + s * P::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kMaxL / 16; ++ks) {
      const uint32_t o = ks * 16 * kRowBytes;
      const uint64_t ahi = wgmma_desc(st + o, kPanel, 1024);
      const uint64_t alo = wgmma_desc(st + kPanel + o, kPanel, 1024);
      const uint64_t b = wgmma_desc(st + 2 * kPanel + o, kPanel, 1024);
      Wgmma<128>::tt(acc, ahi, b);
      Wgmma<128>::tt(acc, alo, b);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s));
  }

  if (lane == 0) bulk_wait<0>();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + 16 * warp + g + 8 * (e >> 1);
      const int col = v0 + 8 * j + 2 * tg + (e & 1);
      if (row < dk && col < dv) {
        C1[bh * cells + static_cast<long long>(row) * dv + col] =
            acc[4 * j + e];
      }
    }
  }
}

// -- pass 2: the output -------------------------------------------------------

constexpr int kOutThreads = 3 * kWg;   // a producer, two consumers
constexpr int kOutStages = 5;
constexpr int kOutStage = kPanel;   // a k panel, a C item or a half v item
constexpr int kCRows = 32;          // rows of dk in a C item
constexpr int kCItemPanel = kCRows * kRowBytes;   // 64 of its columns

// bytes of the output block's shared memory for ndk 64-column panels of q:
// q's 128 rows, the ring, the entering n as a B operand (per 64 columns of
// dk, rows n_hi, n_lo and six of zeros), the chunk's cumsum and log_i, then
// the barriers: each q panel's, then each stage's full and empty one
constexpr int kOutBars = kMaxDkWgmma / 64 + 2 * kOutStages;
constexpr int kNTile = 8 * kRowBytes;
constexpr int kNEach = kMaxDkWgmma / (2 * kWg);   // n's values a consumer
inline int out_smem_bytes(int ndk) {
  return ndk * kPanel + kOutStages * kOutStage + ndk * kNTile +
         2 * kMaxL * 4 + 8 * kOutBars + 1024;
}
static_assert(kMaxDkWgmma / 64 * (kPanel + kNTile) +
                      kOutStages * kOutStage + 2 * kMaxL * 4 + 8 * kOutBars +
                      1024 <=
                  kSmemMax,
              "the output pass's plan fits at the largest dk");

// Block z = bh * nc + j: chunk j.  Warpgroup 0, the producer: one thread
// TMA-loads q's panels once, then a ring of 16 KB items: the k panels (64
// columns of dk, 128 keys), then per 128 columns of h the C items (32 rows
// of dk of the scratch's hi and lo planes) and the two halves of the v
// item (64 columns, 128 steps).  Warpgroups 1 and 2, the consumers, take
// 64 rows of the chunk each: S = q k^T (wgmma SS over dk), the decay, the
// rows' max, the carry and the denominator from the accumulators, P as a
// register hi + lo pair; then per 128 columns acc = q C_hi + q C_lo (wgmma
// SS, C transposed by its descriptor) over dk, acc *= carry dk^-1/2, acc +=
// P v (wgmma RS, hi then lo, v transposed), and h = acc / den stored from
// the registers.  A consumer issues an item's products before it waits for
// the item before's, and then frees that one.
__global__ void __launch_bounds__(kOutThreads, 1)
mlstm_chunk_out_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_chi,
                             const __grid_constant__ CUtensorMap tm_clo,
                             const float* __restrict__ li,
                             const float* __restrict__ lf,
                             const float* __restrict__ nbuf,
                             const float* __restrict__ m_in_buf,
                             bf16* __restrict__ h, long long S, int dk,
                             int dv, int L, int nc, float scale, int vec2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const int ndk = (dk + 63) / 64;
  const int nvt = (dv + 127) / 128;
  const uint32_t ring = base + ndk * kPanel;
  unsigned char* ntile = smem + ndk * kPanel + kOutStages * kOutStage;
  float* cs = reinterpret_cast<float*>(ntile + ndk * kNTile);
  float* lis = cs + kMaxL;
  // q panel p's barrier, stage s's full and empty ones
  const uint32_t bar0 = smem_addr(lis + kMaxL);
  const auto bar_q = [&](int p) { return bar0 + 8 * p; };
  const auto full = [&](int s) {
    return bar0 + 8 * (kMaxDkWgmma / 64 + s);
  };
  const auto empty = [&](int s) {
    return bar0 + 8 * (kMaxDkWgmma / 64 + kOutStages + s);
  };
  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  const int z = blockIdx.x;
  const int bh = z / nc, j = z - (z / nc) * nc;
  const int t0 = j * L;                            // within the head
  const int n = static_cast<int>(min(static_cast<long long>(L), S - t0));

  if (tid == 0) {
    prefetch_tensor_map(&tm_q);
    prefetch_tensor_map(&tm_k);
    prefetch_tensor_map(&tm_v);
    prefetch_tensor_map(&tm_chi);
    prefetch_tensor_map(&tm_clo);
    for (int p = 0; p < ndk; ++p) mbar_init(bar_q(p), 1);
    for (int s = 0; s < kOutStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      // item i: k panel i (i < ndk), then per 128 columns vt of h the C
      // items d < ndk2 and the v item's halves (d = ndk2, ndk2 + 1); a
      // half past dv loads nothing
      const int ndk2 = (dk + kCRows - 1) / kCRows;
      const int items = ndk + nvt * (ndk2 + 2);
      for (int i = 0; i < items; ++i) {
        const int s = i % kOutStages;
        const uint32_t dst = ring + s * kOutStage;
        const uint32_t bar = full(s);
        if (i < ndk) {   // q's panel i ahead of k's, so S can start early
          mbar_arrive_expect_tx(bar_q(i), kPanel);
          tma_load_3d(base + i * kPanel, &tm_q, 64 * i, t0, bh, bar_q(i));
        }
        mbar_wait(empty(s), ((i / kOutStages) & 1) ^ 1);
        if (i < ndk) {
          mbar_arrive_expect_tx(bar, kPanel);
          tma_load_3d(dst, &tm_k, 64 * i, t0, bh, bar);
          continue;
        }
        const int vt = (i - ndk) / (ndk2 + 2), d = (i - ndk) % (ndk2 + 2);
        const int c0 = 128 * vt;
        if (d < ndk2) {
          const int vp = c0 + 64 < dv ? 2 : 1;     // panels in bounds
          mbar_arrive_expect_tx(bar, 2 * vp * kCItemPanel);
          for (int p = 0; p < vp; ++p) {
            tma_load_3d(dst + p * kCItemPanel, &tm_chi, c0 + 64 * p,
                        kCRows * d, z, bar);
            tma_load_3d(dst + (2 + p) * kCItemPanel, &tm_clo, c0 + 64 * p,
                        kCRows * d, z, bar);
          }
        } else {
          const int c = c0 + 64 * (d - ndk2);
          mbar_arrive_expect_tx(bar, c < dv ? kPanel : 0);
          if (c < dv) tma_load_3d(dst, &tm_v, c, t0, bh, bar);
        }
      }
    }
    return;
  }

  // -- a consumer: rows 64 c .. 64 c + 63 of the chunk; accumulator element
  // 4 jj + e is row 64 c + 16 warp + g + 8 (e / 2), column 8 jj + 2 tg + (e
  // % 2) of its 128
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int ctid = tid - wg * kWg;
  const int warp = ctid >> 5, lane = ctid & 31;
  const int g = lane >> 2, tg = lane & 3;
  // the chunk's gates (consumer 0's first warp) and its entering n, for
  // both consumers: loaded now, used after S, so that their latency runs
  // beside S's loads instead of before it
  const bool gater = c == 0 && warp == 0;
  float gf[4], gi[4], nx[kNEach];
  if (gater) gate_inputs(li, lf, bh * S + t0, n, gf, gi, lane);
#pragma unroll
  for (int u = 0; u < kNEach; ++u) {
    const int i = c * kWg + ctid + 2 * kWg * u;
    nx[u] = i < dk ? nbuf[static_cast<long long>(z) * dk + i] : 0.f;
  }
  const float m_in = m_in_buf[z];
  const uint32_t q_rows = base + 64 * c * kRowBytes;
  // S = q k^T over dk, a k panel an item
  float s[64];
  for (int d = 0; d < ndk; ++d) {
    const int st = d % kOutStages;
    mbar_wait(bar_q(d), 0);
    mbar_wait(full(st), (d / kOutStages) & 1);
    wgmma_fence();
    const uint32_t kp = ring + st * kOutStage;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<128>::ss(s, wgmma_desc(q_rows + d * kPanel + ks * 32, 16, 1024),
                     wgmma_desc(kp + ks * 32, 16, 1024), d > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (d > 0 && lane == 0) mbar_arrive(empty((d - 1) % kOutStages));
  }
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) mbar_arrive(empty((ndk - 1) % kOutStages));

  if (gater) {
    warp_gates_from(gf, gi, n, cs, lis, lane);
    __syncwarp();
    for (int s = lane; s < n; s += 32) lis[s] -= cs[s];   // g_s
  }
  // n as the B operand of q . n: per 64 columns of dk a panel of 8 rows
  // (n_hi, n_lo, zeros), 128-byte swizzled
#pragma unroll
  for (int u = 0; u < kNEach; ++u) {
    const int i = c * kWg + ctid + 2 * kWg * u;
    if (i >= ndk * 64) continue;
    const bf16 hi = __float2bfloat16(nx[u]);
    const bf16 lo = __float2bfloat16(nx[u] - __bfloat162float(hi));
    const int lc = (i >> 3) & 7;   // its 16-byte chunk of the row
    unsigned char* panel = ntile + (i >> 6) * kNTile + (i & 7) * 2;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      *reinterpret_cast<bf16*>(panel + r * kRowBytes + ((lc ^ r) << 4)) =
          r == 0 ? hi : r == 1 ? lo : __float2bfloat16(0.f);
    }
  }
  fence_proxy_async();
  named_sync(2, 2 * kWg);   // the gates and n are in

  // q . n of this thread's rows as q n_hi + q n_lo, m64n8 products over
  // dk: column 0 and 1 of the accumulator, held by the quad's first lane
  float qn[2];
  {
    float nq[4] = {0.f, 0.f, 0.f, 0.f};
    fence_regs(nq);
    wgmma_fence();
    for (int d = 0; d < ndk; ++d) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<8>::ss(nq, wgmma_desc(q_rows + d * kPanel + ks * 32, 16, 1024),
                     wgmma_desc(smem_addr(ntile) + d * kNTile + ks * 32, 16,
                                1024),
                     1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(nq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qn[r] = __shfl_sync(0xffffffffu, nq[2 * r] + nq[2 * r + 1], lane & ~3);
    }
  }

  // the rows' statistics and P = (q k^T) dk^-1/2 . D, in place of S: W[t,
  // s] = c_t + g_s with g_s = log_i_s - c_s (in lis), loaded once a column
  float cf[2], inv[2];
  float gv[32];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    gv[2 * jj] = lis[8 * jj + 2 * tg];
    gv[2 * jj + 1] = lis[8 * jj + 2 * tg + 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 64 * c + 16 * warp + g + 8 * r;
    const bool live = t < n;
    const float ct = live ? cs[t] : 0.f;
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int sx = 8 * (i >> 1) + 2 * tg + (i & 1);
      if (live && sx <= t) mx = fmaxf(mx, ct + gv[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_inter = ct + m_in;
    const float m_t = fmaxf(mx, m_inter);
    const float carry = exp2_approx((m_inter - m_t) * kLog2e);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int sx = 8 * (i >> 1) + 2 * tg + (i & 1);
      const int k = 4 * (i >> 1) + 2 * r + (i & 1);
      float p = 0.f;
      if (live && sx <= t) {
        p = s[k] * scale * exp2_approx(((ct + gv[i]) - m_t) * kLog2e);
      }
      s[k] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    inv[r] = 1.f / fmaxf(fabsf(rs + carry * (qn[r] * scale)),
                         exp2_approx(-m_t * kLog2e));
    cf[r] = carry * scale;                        // h's factor of q C
  }
  // P as the A operand of P v, 16 keys a fragment, split hi + lo
  uint32_t ph[8][4], pl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_pair(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                 pl[kk][i]);
    }
  }

  // per 128 columns of h: acc = q C (hi + lo) over dk, acc *= carry dk^-1/2,
  // acc += P v (hi + lo), h = acc / den
  const int ndk2 = (dk + kCRows - 1) / kCRows;
  int it = ndk;
  const long long hrow0 = static_cast<long long>(bh) * S + t0;
  for (int vt = 0; vt < nvt; ++vt) {
    float acc[64];
    for (int d = 0; d < ndk2; ++d, ++it) {
      const int st = it % kOutStages;
      mbar_wait(full(st), (it / kOutStages) & 1);
      wgmma_fence();
      const uint32_t cp = ring + st * kOutStage;
#pragma unroll
      for (int ks = 0; ks < kCRows / 16; ++ks) {
        // dk rows kCRows d + 16 ks: q's panel and 32-byte column step
        const int kq = (kCRows / 16) * d + ks;
        const uint64_t qa = wgmma_desc(
            q_rows + (kq >> 2) * kPanel + (kq & 3) * 32, 16, 1024);
        Wgmma<128>::ss_t(
            acc, qa, wgmma_desc(cp + ks * 16 * kRowBytes, kCItemPanel, 1024),
            d > 0 || ks > 0);
        Wgmma<128>::ss_t(acc, qa,
                         wgmma_desc(cp + 2 * kCItemPanel + ks * 16 * kRowBytes,
                                    kCItemPanel, 1024),
                         1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (d > 0 && lane == 0) mbar_arrive(empty((it - 1) % kOutStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty((it - 1) % kOutStages));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= cf[(i >> 1) & 1];
    fence_regs(acc);
    {
      // P v: the v item's halves into the accumulator's halves
      const int s0 = it % kOutStages, s1 = (it + 1) % kOutStages;
      mbar_wait(full(s0), (it / kOutStages) & 1);
      mbar_wait(full(s1), ((it + 1) / kOutStages) & 1);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      const uint32_t v0 = ring + s0 * kOutStage, v1 = ring + s1 * kOutStage;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t b = wgmma_desc(v0 + kk * 16 * kRowBytes, kPanel, 1024);
        Wgmma<64>::rs_t_at<0>(acc, ph[kk], b);
        Wgmma<64>::rs_t_at<0>(acc, pl[kk], b);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t b = wgmma_desc(v1 + kk * 16 * kRowBytes, kPanel, 1024);
        Wgmma<64>::rs_t_at<32>(acc, ph[kk], b);
        Wgmma<64>::rs_t_at<32>(acc, pl[kk], b);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty(s0));
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(empty(s1));
      it += 2;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 64 * c + 16 * warp + g + 8 * r;
      if (t >= n) continue;
      bf16* hr = h + (hrow0 + t) * dv;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = 128 * vt + 8 * jj + 2 * tg;
        const float x0 = acc[4 * jj + 2 * r] * inv[r];
        const float x1 = acc[4 * jj + 2 * r + 1] * inv[r];
        if (vec2 && col + 1 < dv) {
          *reinterpret_cast<uint32_t*>(hr + col) = pack_bf16(x0, x1);
        } else {
          if (col < dv) hr[col] = __float2bfloat16(x0);
          if (col + 1 < dv) hr[col + 1] = __float2bfloat16(x1);
        }
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
  if (dk > kMaxDkWgmma) {   // the output pass keeps a chunk's q rows in smem
    return launch_cuda_cores<bf16>(q, k, v, li, lf, C0, n0, m0, h, C1, n1,
                                   m1, cbuf, nbuf, sbuf, BH, S, dk, dv, L,
                                   scale, stream);
  }
  const int nc = static_cast<int>((S + L - 1) / L);
  // rows of q, k and v and of the scratch's planes lie a multiple of 8
  // elements (16 bytes) apart, as the tensor maps need
  const long long dkp = (dk + 7) / 8 * 8, dvp = (dv + 7) / 8 * 8;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(cbuf) ||
      BH * S > INT32_MAX) {   // the maps' coordinates are 32-bit
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scratch's states as two bf16 planes, hi then lo; the entering m is
  // sbuf's third plane, as the float32 route leaves it
  bf16* chi = reinterpret_cast<bf16*>(cbuf);
  bf16* clo = chi + BH * nc * static_cast<long long>(dk) * dvp;
  float* m_in = sbuf + 2 * BH * nc;
  // the scratch's planes: the walk stores 64 x 64 boxes, the output pass
  // loads 64 x kCRows ones
  CUtensorMap tm_q, tm_k, tm_v, tm_hi, tm_lo, tm_chi, tm_clo, tm_li, tm_lf;
  if (!aligned16(li) || !aligned16(lf) ||
      !tensor_map_1d_f32(&tm_li, li, BH * S, kGateBox) ||
      !tensor_map_1d_f32(&tm_lf, lf, BH * S, kGateBox) ||
      !tensor_map(&tm_q, q, dk, dkp, S, S, BH, 64, kMaxL) ||
      !tensor_map(&tm_k, k, dk, dkp, S, S, BH, 64, kMaxL) ||
      !tensor_map(&tm_v, v, dv, dvp, S, S, BH, 64, kMaxL) ||
      !tensor_map(&tm_hi, chi, dv, dvp, dk, dk, BH * nc, 64, 64) ||
      !tensor_map(&tm_lo, clo, dv, dvp, dk, dk, BH * nc, 64, 64) ||
      !tensor_map(&tm_chi, chi, dv, dvp, dk, dk, BH * nc, 64, kCRows) ||
      !tensor_map(&tm_clo, clo, dv, dvp, dk, dk, BH * nc, 64, kCRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_walk_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WalkPlan::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out_smem = out_smem_bytes((dk + 63) / 64);
  err = cudaFuncSetAttribute(mlstm_chunk_out_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 g1((dk + 63) / 64, (dv + kWalkCols - 1) / kWalkCols,
                static_cast<unsigned>(BH));
  mlstm_state_walk_wgmma_kernel<<<g1, kWalkThreads, WalkPlan::kSmem,
                                  stream>>>(
      tm_k, tm_v, tm_hi, tm_lo, tm_li, tm_lf, C0, n0, m0, C1, n1, m1, nbuf,
      m_in, S, dk, dv, L, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int vec2 = dv % 2 == 0 &&
                   (reinterpret_cast<std::uintptr_t>(h) & 3) == 0;
  mlstm_chunk_out_wgmma_kernel<<<static_cast<unsigned>(BH * nc), kOutThreads,
                                 out_smem, stream>>>(
      tm_q, tm_k, tm_v, tm_chi, tm_clo, li, lf, nbuf, m_in,
      static_cast<bf16*>(h), S, dk, dv, L, nc, scale, vec2);
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
// dk^-1/2.  mlstm_bf16 at dk <= 512 (the wgmma route) reads the rows of q
// and k round_up(dk, 8) elements apart and those of v round_up(dv, 8)
// apart (h's lie dv apart), takes q, k, v and cbuf on 16-byte aligned
// bases, and holds dv rounded up to 8 in cbuf's last dim.

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

// The dynamic shared memory of mlstm_bf16's two wgmma kernels (the walk,
// the output pass) at head dim dk, in bytes; zeros above 512, where the
// CUDA-core passes run.
int mlstm_bf16_smem(long long dk, int* walk, int* out) {
  const bool wgmma = dk >= 1 && dk <= kMaxDkWgmma;
  *walk = wgmma ? WalkPlan::kSmem : 0;
  *out = wgmma ? out_smem_bytes(static_cast<int>((dk + 63) / 64)) : 0;
  return 0;
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
