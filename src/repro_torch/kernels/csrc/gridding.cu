// Radial gridding and degridding (bilinear interpolation on the periodic
// k-space grid) for Hopper (sm_90a).  Built by repro_torch/kernels/_build.py
// with nvcc into one shared library and bound with ctypes: plain C entry
// points, no PyTorch headers.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gridding/kernel.py:
//   degrid_pallas   out[j, s] = sum_v (Ax g_j)[s, v] * Ay[s, v]
//   grid_pallas     g_j = Ax^T (y_j[:, None] * Ay)      (the exact adjoint)
// The TPU form multiplies dense separable matrices Ax (Sp, X) and
// Ay (Sp, Y), two nonzeros per row, because a TPU has no atomics and its
// matrix unit wants dense tiles.  Here the same operator is read in the
// compact form the gridding plan keeps on the card:
//   taps    idx (Sp, 4) int32 = (ix0, ix1, iy0, iy1),
//           w   (Sp, 4) f32   = (wx0, wx1, wy0, wy1), i.e. the two
//           nonzero columns and values of row s of Ax and of Ay;
//   cells   a cell-major index (CSR) of the adjoint over the T touched
//           cells only: cells[t] = u * grid + v (ascending) owns entries
//           ptr[t] .. ptr[t+1] - 1, each a sample s and its weights
//           (Ax[s, u], Ay[s, v]), in the fixed order of a stable sort on
//           (cell, sample, corner); a bitmap marks the touched cells.
// Complex data is PyTorch's interleaved complex64 (float2): g (J, X, Y),
// samples (J, Sp).
//
// What bounds them on the H100: bytes.  degrid does 18 flops per sample
// and coil against 32 bytes gathered; grid_adjoint 6 flops per entry and
// coil, and must write the whole (J, X, Y) grid.  Both sit two orders of
// magnitude below the card's float32 line.  At the main path's width
// (J = 8, grid 768, 16896 samples, T = 19887 touched cells of 589824)
// degrid moves 2.9 MB; grid_adjoint must write the 37.7 MB grid and read
// the 1.6 MB of samples and taps (the dense pair alone would be 103.8 MB).
//
// What the design does about it:
// - degrid: a thread per (sample, coil).  The 32 lanes of a warp take
//   neighbouring samples, so each coil's writes are coalesced and the
//   gathers of neighbouring samples along a spoke share cache lines; the
//   coils go across the warps of a block, so the 8 threads of a sample
//   read its taps (one 16-byte load each for indices and weights) from L1
//   after one load from memory.  Each thread issues its four gathers
//   together.  Padded rows (s >= S) write 0 and read nothing.
// - grid_adjoint: one launch of two kinds of block, with no atomics.
//   The first blocks, 6 an SM, fill: a thread a cell of the plane,
//   grid-stride, writes a zero to each coil's plane where the bitmap of
//   touched cells has no bit, in 8-byte streaming stores; the 96.6 % of
//   cells no sample touches cost only their share of the write stream.
//   The other blocks gather the touched cells only, a warp a cell in the
//   index's order, beside the fill blocks on the same SMs, so that their
//   dependent loads wait under the fill's stores: lane = slot * 8 + coil,
//   the 4 slots take the cell's entries at a stride of 4 (a DC cell where
//   the 11 spokes cross has 48, a mean cell 3.4) and each lane sums
//   wx * (y_j[s] * wy) for its coil, as Ax^T (y * Ay) does; a fixed
//   butterfly over the slots adds the four sums and lanes 0-7 each write
//   one coil.  More than 8 coils take another round over the same
//   entries.  The two parts write disjoint words, so they need no order
//   between them.  The order of every sum depends only on the cell's
//   entry count, so the result repeats bit for bit; samples of padded
//   rows are never read.
// - What holds grid_adjoint above its bound now: a 32-byte sector that
//   holds a touched cell gets part of its bytes from the fill and part
//   from the gather, and a part of a sector written alone costs the card
//   more than a whole one.  Skipping such sectors whole would need a
//   writer for their other cells that is not a warp of a single cell.
//
// Launch shapes.  Each entry takes its block from the caller (the spec's
// block, chosen by the registry's autotuner when a plan is built): degrid
// its samples a block (the x extent of the block, 32 or 64 lanes), and
// grid_adjoint its warps a block (4, 8 or 16), the fill's blocks scaled so
// that the fill keeps its threads an SM.  The defaults, 32 lanes and 8
// warps (6 fill blocks an SM), are the constants these kernels had.  A
// thread's sample or a warp's cell, and the order of every sum, do not
// depend on the shape, so every block gives the same bits.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kCoilBlock = 8;                 // coils a degrid block, a warp
constexpr int kSlots = 32 / kCoilBlock;       // entry slots of a gather warp
constexpr int kMaxDegridLanes = 64;           // samples a degrid block, most
constexpr int kMaxGatherWarps = 16;           // warps a grid_adjoint block
// the fill's threads an SM: 6 blocks of 8 warps, of the SM's 8 such blocks
constexpr int kFillWarpsPerSm = 6 * 8;

inline unsigned blocks_for(long long n, int per_block) {
  long long b = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// The current device's SM count, read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
      return 1;
    }
  }
  return sms;
}

// t = wa * a + wb * b for complex a, b and real weights.
__device__ __forceinline__ float2 lerp2(float wa, float2 a, float wb,
                                        float2 b) {
  return make_float2(wa * a.x + wb * b.x, wa * a.y + wb * b.y);
}

// blockDim = (lanes samples, min(J, kCoilBlock) coils)
__global__ void __launch_bounds__(kMaxDegridLanes * kCoilBlock)
degrid_kernel(const float2* __restrict__ g, const int4* __restrict__ idx,
              const float4* __restrict__ w, float2* __restrict__ out,
              long long ncoils, long long grid, long long nsamp,
              long long nsamp_padded) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nsamp_padded) return;
  if (s >= nsamp) {
    for (long long j = threadIdx.y; j < ncoils; j += blockDim.y) {
      out[j * nsamp_padded + s] = make_float2(0.0f, 0.0f);
    }
    return;
  }
  const int4 c = __ldg(idx + s);
  const float4 wt = __ldg(w + s);
  const long long plane = grid * grid;
  const long long x0 = c.x * grid, x1 = c.y * grid;
  for (long long j = threadIdx.y; j < ncoils; j += blockDim.y) {
    const float2* gj = g + j * plane;
    const float2 g00 = gj[x0 + c.z], g10 = gj[x1 + c.z];
    const float2 g01 = gj[x0 + c.w], g11 = gj[x1 + c.w];
    // (Ax g_j)[s, v] at the two columns v = iy0, iy1, then the Ay row
    const float2 t0 = lerp2(wt.x, g00, wt.y, g10);
    const float2 t1 = lerp2(wt.x, g01, wt.y, g11);
    out[j * nsamp_padded + s] = lerp2(wt.z, t0, wt.w, t1);
  }
}

// One warp's touched cell, the t-th.  All 32 lanes reach the shuffles:
// the caller's exit is the warp's.
__device__ __forceinline__ void gather_cell(
    long long t, int lane, const float2* __restrict__ y,
    const int* __restrict__ cells, const int* __restrict__ cell_ptr,
    const int* __restrict__ cell_samp, const float2* __restrict__ cell_w,
    float2* __restrict__ out, long long ncoils, long long plane,
    long long nsamp_padded) {
  const int jj = lane % kCoilBlock;
  const int slot = lane / kCoilBlock;
  const long long c = cells[t];
  const int e0 = cell_ptr[t];
  const int e1 = cell_ptr[t + 1];
  for (long long j0 = 0; j0 < ncoils; j0 += kCoilBlock) {
    const long long j = j0 + jj;
    float2 acc = make_float2(0.0f, 0.0f);
    if (j < ncoils) {
      const float2* yj = y + j * nsamp_padded;
#pragma unroll 4
      for (int e = e0 + slot; e < e1; e += kSlots) {
        const float2 wv = cell_w[e];  // (wx, wy)
        const float2 v = yj[cell_samp[e]];
        acc.x += wv.x * (v.x * wv.y);
        acc.y += wv.x * (v.y * wv.y);
      }
    }
    // the slots' sums: lanes slot 0 + 1 and 2 + 3, then the two pairs
#pragma unroll
    for (int o = kCoilBlock; o < 32; o <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    }
    if (slot == 0 && j < ncoils) out[j * plane + c] = acc;
  }
}

// Zeros in every coil's plane at the cells whose bit in `touched` is
// clear: a thread a cell, from thread `first` of `stride`.
__device__ __forceinline__ void fill_untouched(
    long long first, long long stride, const unsigned* __restrict__ touched,
    float2* __restrict__ out, long long ncoils, long long plane) {
  const float2 zero = make_float2(0.0f, 0.0f);
  for (long long c = first; c < plane; c += stride) {
    if ((__ldg(touched + c / 32) >> (c % 32)) & 1u) continue;
    for (long long j = 0; j < ncoils; ++j) __stcs(out + j * plane + c, zero);
  }
}

// Blocks [0, fill) fill, the rest gather, a warp a touched cell.  The two
// parts write disjoint words.
__global__ void __launch_bounds__(kMaxGatherWarps * 32)
grid_adjoint_kernel(const float2* __restrict__ y,
                    const int* __restrict__ cells,
                    const int* __restrict__ cell_ptr,
                    const int* __restrict__ cell_samp,
                    const float2* __restrict__ cell_w,
                    const unsigned* __restrict__ touched,
                    float2* __restrict__ out, long long ncoils,
                    long long plane, long long nsamp_padded,
                    long long ntouched, unsigned fill) {
  if (blockIdx.x < fill) {
    fill_untouched(static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x,
                   static_cast<long long>(fill) * blockDim.x, touched, out,
                   ncoils, plane);
    return;
  }
  const long long warp =
      static_cast<long long>(blockIdx.x - fill) * (blockDim.x / 32) +
      threadIdx.x / 32;
  if (warp >= ntouched) return;
  gather_cell(warp, threadIdx.x % 32, y, cells, cell_ptr, cell_samp, cell_w,
              out, ncoils, plane, nsamp_padded);
}

// The fill's blocks of `warps` warps: kFillWarpsPerSm warps an SM, or
// fewer blocks for a small plane.
inline unsigned fill_blocks(long long plane, int warps) {
  const long long cap =
      static_cast<long long>(sm_count()) * (kFillWarpsPerSm / warps);
  const long long b = blocks_for(plane, warps * 32);
  return static_cast<unsigned>(b < cap ? b : cap);
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// g: (ncoils, grid, grid) complex64; idx/w: (nsamp_padded, 4) taps;
// out: (ncoils, nsamp_padded) complex64; lanes: samples a block, 32 or 64.
int degrid(const void* g, const void* idx, const void* w, void* out,
           long long ncoils, long long grid, long long nsamp,
           long long nsamp_padded, int lanes, void* stream) {
  if (lanes != 32 && lanes != kMaxDegridLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ny = ncoils < 1 ? 1 : (ncoils < kCoilBlock ? ncoils
                                                            : kCoilBlock);
  const dim3 block(lanes, static_cast<unsigned>(ny));
  degrid_kernel<<<blocks_for(nsamp_padded, lanes), block, 0,
                  as_stream(stream)>>>(
      static_cast<const float2*>(g), static_cast<const int4*>(idx),
      static_cast<const float4*>(w), static_cast<float2*>(out), ncoils, grid,
      nsamp, nsamp_padded);
  return static_cast<int>(cudaGetLastError());
}

// y: (ncoils, nsamp_padded) complex64; cells: (ntouched,) int32;
// cell_ptr: (ntouched + 1,) int32; cell_samp: (nnz,) int32;
// cell_w: (nnz, 2) f32; touched: (ceil(grid * grid / 32),) 32-bit words;
// out: (ncoils, grid, grid) complex64; warps: a block's, 4, 8 or 16.
int grid_adjoint(const void* y, const void* cells, const void* cell_ptr,
                 const void* cell_samp, const void* cell_w,
                 const void* touched, void* out, long long ncoils,
                 long long grid, long long nsamp_padded, long long ntouched,
                 int warps, void* stream) {
  if (warps != 4 && warps != 8 && warps != kMaxGatherWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned fill = fill_blocks(grid * grid, warps);
  const long long gather = (ntouched + warps - 1) / warps;
  grid_adjoint_kernel<<<fill + static_cast<unsigned>(gather), warps * 32, 0,
                        as_stream(stream)>>>(
      static_cast<const float2*>(y), static_cast<const int*>(cells),
      static_cast<const int*>(cell_ptr), static_cast<const int*>(cell_samp),
      static_cast<const float2*>(cell_w),
      static_cast<const unsigned*>(touched), static_cast<float2*>(out),
      ncoils, grid * grid, nsamp_padded, ntouched, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
