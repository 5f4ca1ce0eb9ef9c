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
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.  Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

inline unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
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
                                    long long ncoils, long long npix) {
  for (long long p = first_index(); p < npix; p += grid_stride()) {
    const float2 xv = x[p];
    for (long long j = 0; j < ncoils; ++j) {
      z[j * npix + p] = cmul(c[j * npix + p], xv);
    }
  }
}

__global__ void coil_lincomb_kernel(const float2* __restrict__ a,
                                    const float2* __restrict__ x,
                                    const float2* __restrict__ b,
                                    const float2* __restrict__ y,
                                    const float* __restrict__ s,
                                    float2* __restrict__ out,
                                    long long ncoils, long long npix) {
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
                                       long long ncoils, long long npix) {
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
                                  long long ncoils, long long npix) {
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
                                    long long ncoils, long long npix) {
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

int coil_forward(const void* c, const void* x, void* z, long long ncoils,
                 long long npix, void* stream) {
  coil_forward_kernel<<<blocks_for(npix), kThreads, 0, as_stream(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(x),
      static_cast<float2*>(z), ncoils, npix);
  return static_cast<int>(cudaGetLastError());
}

int coil_lincomb(const void* a, const void* x, const void* b, const void* y,
                 const void* s, void* out, long long ncoils, long long npix,
                 void* stream) {
  coil_lincomb_kernel<<<blocks_for(npix), kThreads, 0, as_stream(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(x),
      static_cast<const float2*>(b), static_cast<const float2*>(y),
      static_cast<const float*>(s), static_cast<float2*>(out), ncoils, npix);
  return static_cast<int>(cudaGetLastError());
}

int coil_scale_mult(const void* a, const void* x, const void* s, void* out,
                    long long ncoils, long long npix, void* stream) {
  coil_scale_mult_kernel<<<blocks_for(npix), kThreads, 0,
                           as_stream(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(x),
      static_cast<const float*>(s), static_cast<float2*>(out), ncoils, npix);
  return static_cast<int>(cudaGetLastError());
}

int plane_mult(const void* z, const void* m, void* out, long long ncoils,
               long long npix, void* stream) {
  plane_mult_kernel<<<blocks_for(npix), kThreads, 0, as_stream(stream)>>>(
      static_cast<const float2*>(z), static_cast<const float*>(m),
      static_cast<float2*>(out), ncoils, npix);
  return static_cast<int>(cudaGetLastError());
}

int coil_adjoint(const void* c, const void* z, const void* m, void* out,
                 long long ncoils, long long npix, void* stream) {
  coil_adjoint_kernel<<<blocks_for(npix), kThreads, 0, as_stream(stream)>>>(
      static_cast<const float2*>(c), static_cast<const float2*>(z),
      static_cast<const float*>(m), static_cast<float2*>(out), ncoils, npix);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
