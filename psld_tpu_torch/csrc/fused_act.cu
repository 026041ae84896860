// Fused bias add + leaky ReLU + gain, forward and backward, for Hopper
// (sm_90a).
//
// Replaces psld_tpu/ops/fused_act.py::_fwd_kernel and ::_bwd_kernel
// (launched by _run_elementwise over 512-row tiles of x viewed as (N, C)):
//   forward   y  = where(x + b >= 0, x + b, (x + b) * slope) * scale
//   backward  dx = g * where(x + b >= 0, scale, slope * scale)
// with b = bias[c] already cast to x's dtype. dbias, the sum of dx over
// the rows, stays outside the kernel, as in the JAX package.
//
// What bounds it on the H100: device-memory bytes. Per element it is two
// or three float operations against one read of x (and g) and one write:
// at (131072, 256) bf16 the forward moves 134 MB, 40 us at 3.35 TB/s.
// The design is a grid-stride pass with 16-byte loads and stores: a
// thread owns 16 bytes of consecutive elements (8 bf16 or 4 f32), which
// share one row when C is a multiple of that count, so one division
// finds the channel of all of them. Otherwise (C = 3 or 6 occur), or when
// a pointer is not on a 16-byte boundary, a thread takes one element at a
// time. Rows are not padded: the pass ends at N * C elements.
//
// Rounding follows the JAX package's bf16 arithmetic, where the weakly
// typed Python constants become bf16 before use and every op rounds its
// result: y = bf16(x + b), then bf16(y * slope), then bf16(. * scale).
// The wrapper hands in the constants already rounded to x's dtype; the
// kernel computes each op in f32 (exact for a product of two bf16
// values) with __fadd_rn / __fmul_rn, which the compiler never contracts,
// and rounds after each op. For f32 the rounding steps are the identity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a float rounded to T's precision, kept as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename T>
__device__ __forceinline__ T act_fwd(T x, T b, float slope, float scale) {
  const float y = rnd<T>(__fadd_rn(to_f(x), to_f(b)));
  const float r = y >= 0.f ? y : rnd<T>(__fmul_rn(y, slope));
  return from_f<T>(__fmul_rn(r, scale));
}

template <typename T>
__device__ __forceinline__ T act_bwd(T x, T b, T g, float s_pos,
                                     float s_neg) {
  const float y = rnd<T>(__fadd_rn(to_f(x), to_f(b)));
  return from_f<T>(__fmul_rn(to_f(g), y >= 0.f ? s_pos : s_neg));
}

// Forward (G == false) or backward (G == true: reads g, writes dx) over
// n = rows * c elements, VEC at a time in one 16-byte word (VEC == 1: one
// element at a time, any c and any alignment).
template <typename T, int VEC, bool G>
__global__ void __launch_bounds__(NT)
fused_act_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                 const T* __restrict__ g, T* __restrict__ out, int64_t n,
                 int c, float a, float b) {
  const int64_t packs = n / VEC;
  const int64_t stride = (int64_t)gridDim.x * NT;
  for (int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x; p < packs;
       p += stride) {
    const int64_t i0 = p * VEC;
    const int c0 = (int)(i0 % c);  // VEC > 1: c % VEC == 0, one row
    if constexpr (VEC == 1) {
      if constexpr (G)
        out[i0] = act_bwd(x[i0], bias[c0], g[i0], a, b);
      else
        out[i0] = act_fwd(x[i0], bias[c0], a, b);
    } else {
      const uint4 xu = *reinterpret_cast<const uint4*>(x + i0);
      const T* xv = reinterpret_cast<const T*>(&xu);
      uint4 gu = xu;
      if constexpr (G) gu = *reinterpret_cast<const uint4*>(g + i0);
      const T* gv = reinterpret_cast<const T*>(&gu);
      uint4 ou;
      T* ov = reinterpret_cast<T*>(&ou);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const T bj = bias[c0 + j];
        if constexpr (G)
          ov[j] = act_bwd(xv[j], bj, gv[j], a, b);
        else
          ov[j] = act_fwd(xv[j], bj, a, b);
      }
      *reinterpret_cast<uint4*>(out + i0) = ou;
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool G>
int launch(const void* x, const void* bias, const void* g, void* out,
           int64_t rows, int c, float a, float b, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t n = rows * c;
  const bool vec = c % VEC == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(out);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one thread a pack, at most 8 blocks an SM; the loop strides the rest
  const int64_t work = vec ? n / VEC : n;
  int64_t blocks = (work + NT - 1) / NT;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (vec)
    fused_act_kernel<T, VEC, G>
        <<<(unsigned)blocks, NT, 0, stream>>>(xt, bt, gt, ot, n, c, a, b);
  else
    fused_act_kernel<T, 1, G>
        <<<(unsigned)blocks, NT, 0, stream>>>(xt, bt, gt, ot, n, c, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = fused leaky ReLU of x (rows x c, contiguous) and bias (c, x's
// dtype); slope and scale already rounded to x's dtype. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t.
int psld_fused_lrelu_fwd(const void* x, const void* bias, void* y,
                         long long rows, int c, float slope, float scale,
                         int dtype, void* stream) {
  if (rows < 0 || c < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, false>(x, bias, nullptr, y, rows, c, slope,
                                        scale, s);
    case 1: return launch<__nv_bfloat16, false>(x, bias, nullptr, y, rows, c,
                                                slope, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx = g * (s_pos where x + bias >= 0, else s_neg); the factors already
// rounded to x's dtype.
int psld_fused_lrelu_bwd(const void* x, const void* bias, const void* g,
                         void* dx, long long rows, int c, float s_pos,
                         float s_neg, int dtype, void* stream) {
  if (rows < 0 || c < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, true>(x, bias, g, dx, rows, c, s_pos, s_neg,
                                       s);
    case 1: return launch<__nv_bfloat16, true>(x, bias, g, dx, rows, c,
                                               s_pos, s_neg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* psld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
