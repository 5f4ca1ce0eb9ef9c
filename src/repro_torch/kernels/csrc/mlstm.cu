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
// gates and the state float32, h is written in v's type; all arithmetic is
// float32.  Unlike the TPU kernel, which starts from a zero state and needs
// S divisible by L, this one takes an initial state and any S: the last
// chunk holds S - (nc - 1) L steps and is masked, which is what the
// reference's mlstm_chunkwise computes with its no-op padding steps.
//
// What bounds it on the H100: bytes.  At the path's shape (B = 1, H = 4,
// S = 3072, dk = dv = 512, L = 128) the chunkwise form does 1.61e10 flops
// (q k^T and scores v at 2 L^2 512 each, q C and k^T v at 2 L 512^2 each,
// a chunk; n_t = D k is never formed, see pass 3) against 58.8 MB (q, k,
// v, h in bf16, the gates and the state read and written in float32):
// 0.0176 ms for the bytes, 0.0163 ms on the bf16 tensor cores, 0.240 ms
// on the float32 CUDA cores.
//
// What the design does about it, in this first form: float32 on the CUDA
// cores (no tensor cores yet), and the chunk-parallel form, so that the
// card fills although B x H is 4.  The TPU kernel keeps all of C in VMEM
// across a sequential chunk axis; at dk = dv = 512 that is 1 MiB a head,
// more than a Hopper block's 227 KB of shared memory, so here the states
// live in device memory between three passes:
//   1. chunk_state: per (batch, head, chunk, 64 x 64 tile of C) the
//      chunk's own decayed k^T v, its sum of k and the max of its log
//      weights, all chunks in parallel;
//   2. state_scan: one thread per element of C and n walks the chunks in
//      order and leaves, in place, the state that enters each chunk, and
//      the final state; it loads 8 chunks' states before it writes any
//      (one load and store a chunk in turn took 1.25 ms a call in the
//      served prefill, each load waiting on the last store; 0.073 ms so);
//   3. chunk_out: per (batch, head, chunk, 64 columns of h) the outputs
//      from the entering state: q k^T and q C over dk in steps of 32
//      (q and k stored transposed in shared memory), the decay and the
//      rows' max and sums with warp shuffles, then the scores times v.
//      q . n_t is the row sum of the masked scores plus the carried
//      e^{c_t + m - m_t} q . n, so n_t itself is never formed.
// Each of the 8 column tiles of a chunk recomputes q k^T: the price of
// filling 768 blocks at the served shape.  Every sum runs in a fixed order
// and nothing uses atomics, so two runs give the same bits.
//
// The C entry launches the three kernels on the caller's stream and
// returns the first cudaGetLastError() that is not 0; the Python wrapper
// raises then.  The wrapper allocates the scratch: one (dk, dv) and one dk
// state and three scalars per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 128;       // largest chunk
constexpr int kThreads = 256;    // 16 row groups x 16 lanes
constexpr int kTile = 64;        // C tile (dk x dv) of chunk_state
constexpr int kSub = 32;         // steps per sub-chunk of chunk_state
constexpr int kTK = 32;          // dk per step of chunk_out
constexpr int kBV = 64;          // columns of h per chunk_out block
constexpr int kPS = kMaxL + 1;   // row stride (floats) of q^T, k^T, P
constexpr int kScanBatch = 8;    // chunks state_scan loads at once
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
// log_f over its n valid steps, lis = log_i.  Warp 0 does it, lane l
// summing steps 4l..4l+3 in order, then a shuffle scan of the lanes.
__device__ void chunk_gates(const float* __restrict__ li,
                            const float* __restrict__ lf, long long base,
                            int n, float* cs, float* lis) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* li,
           const float* lf, const float* C0, const float* n0,
           const float* m0, void* h, float* C1, float* n1, float* m1,
           float* cbuf, float* nbuf, float* sbuf, long long BH, long long S,
           int dk, int dv, int L, float scale, cudaStream_t stream) {
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

}  // namespace

extern "C" {

// q, k: (BH, S, dk); v, h: (BH, S, dv); log_i, log_f: (BH, S) float32;
// C0, C1: (BH, dk, dv), n0, n1: (BH, dk), m0, m1: (BH) float32; all
// contiguous.  q, k, v, h float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// Scratch, float32: cbuf (BH, nc, dk, dv), nbuf (BH, nc, dk), sbuf
// (3, BH, nc), nc = ceil(S / L).  1 <= L <= 128, S >= 1; scale = dk^-1/2.
int mlstm(const void* q, const void* k, const void* v, const void* log_i,
          const void* log_f, const void* C0, const void* n0, const void* m0,
          void* h, void* C1, void* n1, void* m1, void* cbuf, void* nbuf,
          void* sbuf, long long BH, long long S, long long dk, long long dv,
          long long L, float scale, int bf16, void* stream) {
  if (BH < 1 || S < 1 || dk < 1 || dv < 1 || L < 1 || L > kMaxL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (bf16) {
    return launch<__nv_bfloat16>(
        q, k, v, f(log_i), f(log_f), f(C0), f(n0), f(m0), h, w(C1), w(n1),
        w(m1), w(cbuf), w(nbuf), w(sbuf), BH, S, static_cast<int>(dk),
        static_cast<int>(dv), static_cast<int>(L), scale,
        as_stream(stream));
  }
  return launch<float>(q, k, v, f(log_i), f(log_f), f(C0), f(n0), f(m0), h,
                       w(C1), w(n1), w(m1), w(cbuf), w(nbuf), w(sbuf), BH, S,
                       static_cast<int>(dk), static_cast<int>(dv),
                       static_cast<int>(L), scale, as_stream(stream));
}

}  // extern "C"
