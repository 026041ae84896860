// Single-head full-spatial attention, forward, for Hopper (sm_90a).
//
// Replaces psld_tpu/ops/attention.py::_attn_kernel (launched by
// _pallas_attention): out = softmax(q k^T * scale) v per batch element,
// with f32 scores, max subtraction, and the probabilities P kept in f32
// for the P v product (the reference upcasts v), one cast to q's dtype.
//
// What bounds it on the H100: arithmetic. At N=256 tokens and C=256
// channels a batch element is 2*2*N*N*C = 67 MFLOP against 512 KB of
// bf16 q/k/v/o, far above the bytes line; with P in f32 the products run
// on the CUDA cores (FMA), not the bf16 tensor cores.
//
// The TPU kernel keeps q, k, v and the whole (N, N) score matrix of one
// batch element in VMEM. Here K and V alone are 256 KB at N=C=256 in bf16,
// above the 227 KB a block may have, so the design streams them:
//   - one block per (batch element, 64-query tile), 256 threads;
//   - phase 1 streams K in 64-key tiles and 32-channel chunks, each thread
//     holding a 4x4 register tile of scores, and writes the tile's f32
//     scores into shared memory S (key-major, at most 256 x 64 = 64 KB);
//   - phase 2 is an exact row softmax over S, as the reference computes it
//     (max, exp, sum, divide; no online rescaling);
//   - phase 3 streams V in 32-key chunks for each 64-channel output tile,
//     again with 4x4 register tiles, reading P from S.
// Shapes: N <= 256 tokens, C a multiple of 8 up to 512, (B, N, C)
// contiguous; f32 or bf16 in and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;   // query rows per block
constexpr int TK = 64;   // keys per score tile; channels per output tile
constexpr int KC = 32;   // depth of one shared-memory chunk
constexpr int NT = 256;  // threads per block: 16 x 16 threads of 4x4 tiles
constexpr int MAX_N = 256;
constexpr int MAX_C = 512;

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// acc[i][j] += sum_kk a[kk][ty*4+i] * b[kk][tx*4+j] over one KC chunk
__device__ __forceinline__ void mma_chunk(const float* a, int lda,
                                          const float* b, int ldb, int ty,
                                          int tx, float (&acc)[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk * lda + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + kk * ldb + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

size_t smem_bytes(int n) {
  const int npad = (n + TK - 1) / TK * TK;
  return sizeof(float) * (size_t)(npad * TQ + KC * TQ + KC * TK + 4 * TQ);
}

template <typename T>
__global__ void __launch_bounds__(NT)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int n,
                     int c, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int npad = (n + TK - 1) / TK * TK;
  float* st = smem;             // [npad][TQ]: scores, then P, key-major
  float* as = st + npad * TQ;   // [KC][TQ]: q chunk, transposed
  float* bs = as + KC * TQ;     // [KC][TK]: k chunk transposed / v chunk
  float* red = bs + KC * TK;    // [4][TQ]: softmax partials

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * TQ;
  const size_t base = (size_t)blockIdx.y * n * c;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  T* ob = o + base;

  // loader for a 64-row x 32-channel chunk: 8 contiguous channels a thread
  const int lr = tid / 4, lc = (tid % 4) * 8;

  // ---- phase 1: S = (q k^T) * scale, tile by tile
  for (int k0 = 0; k0 < n; k0 += TK) {
    float acc[4][4] = {};
    for (int c0 = 0; c0 < c; c0 += KC) {
      float buf[8];
      const int col = c0 + lc;
      int row = q0 + lr;
      if (row < n && col < c) {
        load8(qb + (size_t)row * c + col, buf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) buf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) as[(lc + e) * TQ + lr] = buf[e];
      row = k0 + lr;
      if (row < n && col < c) {
        load8(kb + (size_t)row * c + col, buf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) buf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) bs[(lc + e) * TK + lr] = buf[e];
      __syncthreads();
      mma_chunk(as, TQ, bs, TK, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      const float col4[4] = {acc[0][j] * scale, acc[1][j] * scale,
                             acc[2][j] * scale, acc[3][j] * scale};
      store4(st + key * TQ + ty * 4, col4);
    }
  }
  __syncthreads();

  // ---- phase 2: exact row softmax; 4 threads a row, rows across lanes
  {
    const int row = tid % TQ, part = tid / TQ;
    float m = -INFINITY;
    for (int key = part; key < n; key += 4) m = fmaxf(m, st[key * TQ + row]);
    red[part * TQ + row] = m;
    __syncthreads();
    m = fmaxf(fmaxf(red[row], red[TQ + row]),
              fmaxf(red[2 * TQ + row], red[3 * TQ + row]));
    __syncthreads();
    float s = 0.f;
    for (int key = part; key < n; key += 4) {
      const float e = expf(st[key * TQ + row] - m);
      st[key * TQ + row] = e;
      s += e;
    }
    red[part * TQ + row] = s;
    __syncthreads();
    s = (red[row] + red[TQ + row]) + (red[2 * TQ + row] + red[3 * TQ + row]);
    for (int key = part; key < n; key += 4) st[key * TQ + row] /= s;
    __syncthreads();
  }

  // ---- phase 3: out = P v, one 64-channel tile at a time
  const int vr = tid / 8, vc = (tid % 8) * 8;  // 32 keys x 64 channels
  for (int n0 = 0; n0 < c; n0 += TK) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < n; k0 += KC) {
      float buf[8];
      const int key = k0 + vr, ch = n0 + vc;
      if (key < n && ch < c) {
        load8(vb + (size_t)key * c + ch, buf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) buf[e] = 0.f;
      }
      store4(bs + vr * TK + vc, buf);
      store4(bs + vr * TK + vc + 4, buf + 4);
      __syncthreads();
      mma_chunk(st + k0 * TQ, TQ, bs, TK, ty, tx, acc);
      __syncthreads();
    }
    const int ch = n0 + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < n && ch < c) store4(ob + (size_t)row * c + ch, acc[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + TQ - 1) / TQ, b);
  attention_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, c, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int psld_attention_fwd(const void* q, const void* k, const void* v, void* o,
                       int b, int n, int c, float scale, int dtype,
                       void* stream) {
  if (b < 1 || b > 65535 || n < 1 || n > MAX_N || c < 8 || c > MAX_C ||
      c % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, o, b, n, c, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k, v, o, b, n, c, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* psld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
