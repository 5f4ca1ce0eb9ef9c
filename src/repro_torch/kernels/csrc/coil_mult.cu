// Pointwise coil-sensitivity kernels of the NLINV operators, for Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into one
// shared library and bound with ctypes: plain C entry points, no PyTorch
// headers.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/coil_mult/kernel.py:
//   coil_forward_pallas     z_j   = c_j * x
//   coil_lincomb_pallas     out_j = s * (a * x_j + b * y_j)
//   coil_scale_mult_pallas  out_j = s * (a * x_j)
//   plane_mult_pallas       out_j = z_j * m
//   coil_adjoint_pallas     out   = m * sum_j conj(c_j) * z_j
// with c, x, y, z complex (J, X, Y) coil stacks, a, b, x complex (X, Y)
// planes and s, m real (X, Y) planes.
//
// What bounds them on the H100: bytes.  Each does 2 to 14 flops per 8-byte
// complex value it moves, far below the card's float32 line of about 20
// flops per byte (67 TFLOP/s over 3.35 TB/s), so the least time is the
// device-memory traffic: every input read once, every output written once.
//
// What the design does about it: complex64 travels as interleaved float2,
// PyTorch's own layout, so no re/im split or join pass is paid around the
// kernel (the TPU's plane split was a lane choice).  One thread owns one
// pixel of the (X, Y) plane and walks the J coils of the stack in a loop:
// the planes (a, b, s, m, x) are read once per pixel instead of once per
// coil, and neighbouring threads touch neighbouring 8-byte words of every
// coil plane, so each warp's accesses coalesce.  A grid-stride loop takes
// any pixel count; the ragged edge is the loop bound.  coil_adjoint sums
// over j inside the thread in a fixed order: deterministic, no atomics.
//
// coil_forward (168 launches a frame) has a second form for an even pixel
// count on 16-byte aligned operands: a thread owns two pixels, so x and
// each coil plane come as one 16-byte load, and it issues the loads of up
// to 8 coils before their stores, so that several loads are in flight
// where the one-pixel loop keeps one.  The coil planes, read once and
// written once, go through the streaming cache hints (ld.global.cs,
// st.global.cs): on the H100 the form came near the rate of a
// device-to-device copy only with both.  Its grid is what the SMs hold at
// once (16 blocks of 128 threads each), and the grid-stride loop walks the
// rest.  Each element is the same one complex product as in the one-pixel
// form, so both give the same bits.  An odd pixel count (coil planes at
// 8-byte offsets) takes the one-pixel form.
//
// Every entry takes a leading batch of B independent rows (the serving
// layer's clients, solved in one launch): the stacks are (B, J, X, Y) and
// each plane operand carries a row stride, 0 for a plane that every row
// shares (fov, weight) and X * Y for a plane of each row (the sampling
// mask, the Newton point's planes).  The row is the grid's second
// dimension (blockIdx.y), so a row's pixels, coils and order of summation
// are those of the unbatched call: at B = 1 with stride 0 the entries are
// the unbatched kernels, bit for bit, and no row's bits depend on another
// row or on B.  This is what Pallas's batching rule does to the TPU
// kernels under the JAX package's vmapped frame: one more grid dimension.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  Launches go on the caller's stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;
constexpr int kPairThreads = 128;    // coil_forward's two-pixel form
constexpr int kBlocksPerSm = 16;     // 2048 threads: what an SM holds
constexpr int kCoilsInFlight = 8;    // coil loads issued before stores

inline unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
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

// A grid of kPairThreads-thread blocks that the SMs hold at once, or
// fewer blocks for a small n.
inline unsigned resident_blocks(long long n) {
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const long long b = (n + kPairThreads - 1) / kPairThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < cap ? b : cap));
}

// One row of the grid a batch row; a batch past the grid's second
// dimension is refused.
constexpr long long kMaxBatch = 65535;

inline dim3 batch_grid(unsigned blocks, long long batch) {
  return dim3(blocks, static_cast<unsigned>(batch));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// This block's batch row.
__device__ __forceinline__ long long row() {
  return static_cast<long long>(blockIdx.y);
}

// a * b
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__global__ void coil_forward_kernel(const float2* __restrict__ c,
                                    const float2* __restrict__ x,
                                    float2* __restrict__ z,
                                    long long ncoils, long long npix,
                                    long long x_row) {
  c += row() * ncoils * npix;
  z += row() * ncoils * npix;
  x += row() * x_row;
  for (long long p = first_index(); p < npix; p += grid_stride()) {
    const float2 xv = x[p];
    for (long long j = 0; j < ncoils; ++j) {
      z[j * npix + p] = cmul(c[j * npix + p], xv);
    }
  }
}

// c * x for two complex values packed in a float4, each as cmul does it
__device__ __forceinline__ float4 cmul2(float4 c, float4 x) {
  const float2 lo = cmul(make_float2(c.x, c.y), make_float2(x.x, x.y));
  const float2 hi = cmul(make_float2(c.z, c.w), make_float2(x.z, x.w));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// coil_forward two pixels a thread: npairs = npix / 2 float4 words a plane
__global__ void __launch_bounds__(kPairThreads)
coil_forward_pairs_kernel(const float4* __restrict__ c,
                          const float4* __restrict__ x,
                          float4* __restrict__ z, long long ncoils,
                          long long npairs, long long x_row) {
  c += row() * ncoils * npairs;
  z += row() * ncoils * npairs;
  x += row() * x_row;
  for (long long p = first_index(); p < npairs; p += grid_stride()) {
    const float4 xv = x[p];
    for (long long j = 0; j < ncoils; j += kCoilsInFlight) {
      float4 cv[kCoilsInFlight];
#pragma unroll
      for (int u = 0; u < kCoilsInFlight; ++u) {
        cv[u] = j + u < ncoils ? __ldcs(c + (j + u) * npairs + p)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kCoilsInFlight; ++u) {
        if (j + u < ncoils) {
          __stcs(z + (j + u) * npairs + p, cmul2(cv[u], xv));
        }
      }
    }
  }
}

__global__ void coil_lincomb_kernel(const float2* __restrict__ a,
                                    const float2* __restrict__ x,
                                    const float2* __restrict__ b,
                                    const float2* __restrict__ y,
                                    const float* __restrict__ s,
                                    float2* __restrict__ out,
                                    long long ncoils, long long npix,
                                    long long a_row, long long b_row,
                                    long long s_row) {
  x += row() * ncoils * npix;
  y += row() * ncoils * npix;
  out += row() * ncoils * npix;
  a += row() * a_row;
  b += row() * b_row;
  if (s != nullptr) s += row() * s_row;
  for (long long p = first_index(); p < npix; p += grid_stride()) {
    const float2 av = a[p];
    const float2 bv = b[p];
    const float sv = s == nullptr ? 1.0f : s[p];
    for (long long j = 0; j < ncoils; ++j) {
      const float2 t0 = cmul(av, x[j * npix + p]);
      const float2 t1 = cmul(bv, y[j * npix + p]);
      out[j * npix + p] = make_float2(sv * (t0.x + t1.x), sv * (t0.y + t1.y));
    }
  }
}

__global__ void coil_scale_mult_kernel(const float2* __restrict__ a,
                                       const float2* __restrict__ x,
                                       const float* __restrict__ s,
                                       float2* __restrict__ out,
                                       long long ncoils, long long npix,
                                       long long a_row, long long s_row) {
  x += row() * ncoils * npix;
  out += row() * ncoils * npix;
  a += row() * a_row;
  if (s != nullptr) s += row() * s_row;
  for (long long p = first_index(); p < npix; p += grid_stride()) {
    const float2 av = a[p];
    const float sv = s == nullptr ? 1.0f : s[p];
    for (long long j = 0; j < ncoils; ++j) {
      const float2 t = cmul(av, x[j * npix + p]);
      out[j * npix + p] = make_float2(sv * t.x, sv * t.y);
    }
  }
}

__global__ void plane_mult_kernel(const float2* __restrict__ z,
                                  const float* __restrict__ m,
                                  float2* __restrict__ out,
                                  long long ncoils, long long npix,
                                  long long m_row) {
  z += row() * ncoils * npix;
  out += row() * ncoils * npix;
  m += row() * m_row;
  for (long long p = first_index(); p < npix; p += grid_stride()) {
    const float mv = m[p];
    for (long long j = 0; j < ncoils; ++j) {
      const float2 v = z[j * npix + p];
      out[j * npix + p] = make_float2(v.x * mv, v.y * mv);
    }
  }
}

__global__ void coil_adjoint_kernel(const float2* __restrict__ c,
                                    const float2* __restrict__ z,
                                    const float* __restrict__ m,
                                    float2* __restrict__ out,
                                    long long ncoils, long long npix,
                                    long long m_row) {
  c += row() * ncoils * npix;
  z += row() * ncoils * npix;
  out += row() * npix;
  if (m != nullptr) m += row() * m_row;
  for (long long p = first_index(); p < npix; p += grid_stride()) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (long long j = 0; j < ncoils; ++j) {  // fixed order: j = 0, 1, ...
      const float2 t = cmul_conj(c[j * npix + p], z[j * npix + p]);
      acc.x += t.x;
      acc.y += t.y;
    }
    const float mv = m == nullptr ? 1.0f : m[p];
    out[p] = make_float2(acc.x * mv, acc.y * mv);
  }
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// Arguments, for every entry: the operands, then batch (B >= 1 rows),
// ncoils (J planes a row), npix (X * Y), then each plane operand's row
// stride (0: shared by the rows; npix: one plane a row), then the stream.

int coil_forward(const void* c, const void* x, void* z, long long batch,
                 long long ncoils, long long npix, long long x_row,
                 void* stream) {
  if (batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (npix % 2 == 0 && aligned16(c) && aligned16(x) && aligned16(z)) {
    const long long npairs = npix / 2;
    coil_forward_pairs_kernel<<<batch_grid(resident_blocks(npairs), batch),
                                kPairThreads, 0, as_stream(stream)>>>(
        static_cast<const float4*>(c), static_cast<const float4*>(x),
        static_cast<float4*>(z), ncoils, npairs, x_row / 2);
  } else {
    coil_forward_kernel<<<batch_grid(blocks_for(npix), batch), kThreads, 0,
                          as_stream(stream)>>>(
        static_cast<const float2*>(c), static_cast<const float2*>(x),
        static_cast<float2*>(z), ncoils, npix, x_row);
  }
  return static_cast<int>(cudaGetLastError());
}

int coil_lincomb(const void* a, const void* x, const void* b, const void* y,
                 const void* s, void* out, long long batch, long long ncoils,
                 long long npix, long long a_row, long long b_row,
                 long long s_row, void* stream) {
  if (batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  coil_lincomb_kernel<<<batch_grid(blocks_for(npix), batch), kThreads, 0,
                        as_stream(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(x),
      static_cast<const float2*>(b), static_cast<const float2*>(y),
      static_cast<const float*>(s), static_cast<float2*>(out), ncoils, npix,
      a_row, b_row, s_row);
  return static_cast<int>(cudaGetLastError());
}

int coil_scale_mult(const void* a, const void* x, const void* s, void* out,
                    long long batch, long long ncoils, long long npix,
                    long long a_row, long long s_row, void* stream) {
  if (batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  coil_scale_mult_kernel<<<batch_grid(blocks_for(npix), batch), kThreads, 0,
                           as_stream(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(x),
      static_cast<const float*>(s), static_cast<float2*>(out), ncoils, npix,
      a_row, s_row);
  return static_cast<int>(cudaGetLastError());
}

int plane_mult(const void* z, const void* m, void* out, long long batch,
               long long ncoils, long long npix, long long m_row,
               void* stream) {
  if (batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plane_mult_kernel<<<batch_grid(blocks_for(npix), batch), kThreads, 0,
                      as_stream(stream)>>>(
      static_cast<const float2*>(z), static_cast<const float*>(m),
      static_cast<float2*>(out), ncoils, npix, m_row);
  return static_cast<int>(cudaGetLastError());
}

// out: (B, X, Y), one plane a row.
int coil_adjoint(const void* c, const void* z, const void* m, void* out,
                 long long batch, long long ncoils, long long npix,
                 long long m_row, void* stream) {
  if (batch < 1 || batch > kMaxBatch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  coil_adjoint_kernel<<<batch_grid(blocks_for(npix), batch), kThreads, 0,
                        as_stream(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(z),
      static_cast<const float*>(m), static_cast<float2*>(out), ncoils, npix,
      m_row);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
