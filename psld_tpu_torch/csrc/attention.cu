// Single-head full-spatial attention, forward, for Hopper (sm_90a).
//
// Replaces psld_tpu/ops/attention.py::_attn_kernel (launched by
// _pallas_attention): out = softmax(q k^T * scale) v per batch element,
// with f32 scores, an exact row max, the probabilities P kept in f32 for
// the P v product (the reference upcasts v), one cast to q's dtype.
// Shapes: N <= 256 tokens, C a multiple of 8 up to 512, (B, N, C)
// contiguous; f32 or bf16 in and out.
//
// What bounds it on the H100: arithmetic. At N = C = 256 a batch element
// is 2 * 2 * N * N * C = 67 MFLOP against 512 KB of bf16 q, k, v, o, far
// above the bytes line; so the bf16 path runs its products on the tensor
// cores.
//
// bf16 (the paths' type): one block per (batch element, 128 query rows),
// two warpgroups of 64 rows (one warpgroup of 64 where N <= 64).
//   - Copies: cp.async (16 bytes a thread, zero fill past N and C) into
//     shared memory tiles of 128-byte rows whose 16-byte pieces are
//     XOR-swizzled by row, the layout wgmma's 128-byte swizzle mode reads.
//     Q's tiles stay resident; K's, then V's, 64-channel chunks of all
//     keys stream through a ring of three slots, so two are in flight
//     while one is multiplied. Both warpgroups share each K and V tile:
//     K and V leave L2 once for 128 queries, not for 64.
//   - Q K^T: wgmma m64n64k16, bf16 in, f32 accumulators (exact as the
//     reference's preferred_element_type=f32), A (Q) and B (K, row-major
//     as (N, C), K-major) read from shared memory through descriptors. A
//     thread keeps its rows' scores for every key: N / 2 floats.
//   - Softmax: keys past N are set to -inf before the max (the zero-filled
//     K rows would otherwise score 0); then max, expf, sum and an IEEE
//     divide in f32 on the accumulators, with quad shuffles across the
//     four lanes that share a row: the reference's exact softmax, no
//     online rescaling.
//   - P V: P = P_hi + P_lo, two bf16 terms (P_lo = bf16(P - P_hi)), each
//     multiplied by V into one f32 accumulator: wgmma m64n64k16 with A
//     from registers (the score accumulators of keys 16j.. are, element
//     for element, the A fragment of k-step j, so P never goes through
//     shared memory) and B = V's tile, MN-major. V's bf16 values are
//     exact and P keeps ~16 bits (relative error ~2^-17 against 2^-9 for
//     one bf16 rounding), so the result differs from the f32 reference by
//     the order of the f32 sums and the final rounding to bf16: the card
//     measures the same max abs error as the f32 SIMT kernel it replaces
//     (0.00195 at the flagship's N = 256, 0.0039 at N = 16 and 64, one
//     bf16 step of the output either way).
//   - Registers at N = 256: 128 scores, then 128 packed P halves, and 32
//     accumulators a thread; one block an SM, 255 registers, no spills.
//
// f32 (only the card-vs-CPU checks): the SIMT design of the first port,
// one block of 256 threads per (batch element, 64-query tile): scores in
// 4x4 register tiles from 32-channel chunks, written key-major into shared
// memory, an exact row softmax there, then P v from the same tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int MAX_N = 256;
constexpr int MAX_C = 512;

// ---------------------------------------------------------------- bf16

constexpr int BK = 64;              // keys of one key tile
constexpr int BC = 64;              // channels of one ring / Q tile
constexpr int STAGES = 3;           // ring slots

// element offset of (row, 8-channel piece j) in a tile of 128-byte rows,
// swizzled as wgmma's 128-byte mode reads it
__device__ __forceinline__ int swz(int row, int j) {
  return row * BC + ((j ^ (row & 7)) << 3);
}

// rows [0, rows) of an (n, c) matrix from r0 on, channels [c0, c0 + 64),
// into a tile, zeros outside it, in 16-byte pieces
template <int NTH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int r0, int c0, int n, int c,
                                          int tid) {
  for (int id = tid; id < rows * 8; id += NTH) {
    const int row = id >> 3, j = id & 7;
    const int gr = r0 + row, gc = c0 + (j << 3);
    const bool ok = gr < n && gc < c;
    psld::cp_async16(dst + swz(row, j), ok ? src + (size_t)gr * c + gc : src,
                     ok);
  }
}

// The ring streams 2 * ncc tiles of all NKT * 64 (padded) keys by 64
// channels: K's channel chunks 0..ncc-1, then V's.
template <int NKT, int NTH>
struct Ring {
  static constexpr int SLOT = NKT * BK * BC;  // bf16 elements of a slot
  __nv_bfloat16* ring;
  const __nv_bfloat16 *k, *v;
  int n, c, ncc, tid;

  __device__ __forceinline__ void fetch(int t) {
    load_tile<NTH>(ring + (t % STAGES) * SLOT, t < ncc ? k : v, NKT * BK, 0,
                   (t < ncc ? t : t - ncc) * BC, n, c, tid);
  }

  // tile t, once it has arrived and is visible to wgmma; starts the copy
  // of tile t + STAGES - 1 into the slot that tile t - 1 freed
  __device__ __forceinline__ const __nv_bfloat16* next(int t) {
    psld::cp_async_wait<STAGES - 2>();
    psld::fence_proxy_async();
    __syncthreads();
    if (t + STAGES - 1 < 2 * ncc) fetch(t + STAGES - 1);
    psld::cp_async_commit();  // empty groups keep the count uniform
    return ring + (t % STAGES) * SLOT;
  }
};

// WG warpgroups, each 64 query rows (a warp 16); NKT key tiles of 64
template <int NKT, int WG>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? 2 : 1)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int n, int c,
                      float scale) {
  constexpr int BQ = 64 * WG, NTH = 128 * WG;
  extern __shared__ uint4 smem_u4[];
  // the swizzle is anchored to 1024-byte boundaries
  uint8_t* raw = reinterpret_cast<uint8_t*>(smem_u4);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      raw + ((1024 - (psld::smem_u32(raw) & 1023)) & 1023));
  const int ncc = (c + BC - 1) / BC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * c;
  Ring<NKT, NTH> ring{qs + ncc * BQ * BC, k + base, v + base, n, c, ncc, tid};

  // Q's tiles form the first commit group, then the ring's first tiles
  for (int cc = 0; cc < ncc; ++cc)
    load_tile<NTH>(qs + cc * BQ * BC, q + base, BQ, q0, cc * BC, n, c, tid);
  psld::cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < 2 * ncc) ring.fetch(t);
    psld::cp_async_commit();
  }

  // ---- scores: s[kt] is the m64n64 accumulator of keys kt*64.. for this
  // warpgroup's 64 rows; element 4*i + e of a thread: row lane/4 (+8 for
  // e >= 2) of its warp's 16, key 8*i + 2*(lane%4) + (e & 1). Channels
  // and keys past C and N are zeros in shared memory: no guards, so the
  // wgmma stream has no branch.
  float s[NKT][32];
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
    for (int e = 0; e < 32; ++e) s[kt][e] = 0.f;
  const __nv_bfloat16* q_wg = qs + (warp >> 2) * 64 * BC;
  for (int cc = 0; cc < ncc; ++cc) {
    const __nv_bfloat16* k_tile = ring.next(cc);
    const __nv_bfloat16* q_tile = q_wg + cc * BQ * BC;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) psld::fence_regs(s[kt]);
    psld::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt)
        psld::wgmma_ss(s[kt], psld::sw128_desc(q_tile + ks * 16),
                       psld::sw128_desc(k_tile + kt * BK * BC + ks * 16));
    psld::wgmma_commit();
    psld::wgmma_wait<0>();
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) psld::fence_regs(s[kt]);
  }

  // ---- exact softmax of rows lane/4 (e = 0, 1) and lane/4 + 8 (e = 2, 3)
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = kt * BK + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      const float w = key < n ? s[kt][e] * scale : -INFINITY;
      s[kt][e] = w;
      if ((e & 2) == 0) m0 = fmaxf(m0, w); else m1 = fmaxf(m1, w);
    }
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, d));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, d));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float w = expf(s[kt][e] - ((e & 2) == 0 ? m0 : m1));
      s[kt][e] = w;
      if ((e & 2) == 0) l0 += w; else l1 += w;
    }
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  // P = P_hi + P_lo; the accumulators of keys 16j.. are the register A
  // operand of k-step j: (row, keys +0..7), (row + 8, +0..7),
  // (row, +8..15), (row + 8, +8..15)
  uint32_t ph[NKT * 4][4], pl[NKT * 4][4];
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
    for (int js = 0; js < 4; ++js)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int e = 4 * (2 * js + (h >> 1)) + (h & 1) * 2;
        const float den = (h & 1) ? l1 : l0;
        const float a = s[kt][e] / den, b = s[kt][e + 1] / den;
        const uint32_t hi = psld::pack_bf16(a, b);
        const float2 back = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi));
        ph[kt * 4 + js][h] = hi;
        pl[kt * 4 + js][h] = psld::pack_bf16(a - back.x, b - back.y);
      }

  // ---- out = P_hi V + P_lo V, one 64-channel chunk of V a tile
  const int row0 = q0 + warp * 16 + (lane >> 2);
  __nv_bfloat16* ob = o + base;
  for (int oc = 0; oc < ncc; ++oc) {
    const __nv_bfloat16* v_tile = ring.next(ncc + oc);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    psld::fence_regs(acc);
    psld::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
      for (int js = 0; js < 4; ++js) {
        const uint64_t d =
            psld::sw128_desc(v_tile + (kt * BK + js * 16) * BC);
        psld::wgmma_rs(acc, ph[kt * 4 + js], d);
        psld::wgmma_rs(acc, pl[kt * 4 + js], d);
      }
    psld::wgmma_commit();
    psld::wgmma_wait<0>();
    psld::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = oc * BC + i * 8 + 2 * (lane & 3);
      if (col >= c) continue;
      if (row0 < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * c + col) =
            psld::pack_bf16(acc[4 * i], acc[4 * i + 1]);
      if (row0 + 8 < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(row0 + 8) * c + col) =
            psld::pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  psld::cp_async_wait<0>();
}

template <int NKT, int WG>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int n, int c, float scale, cudaStream_t stream) {
  constexpr int BQ = 64 * WG;
  const int ncc = (c + BC - 1) / BC;
  // Q's tiles, the ring, and room to align both to 1024 bytes
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)ncc * BQ * BC +
                                               STAGES * NKT * BK * BC) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_kernel<NKT, WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_bf16_kernel<NKT, WG><<<grid, 128 * WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n, c, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32

constexpr int TQ = 64;   // query rows per block
constexpr int TK = 64;   // keys per score tile; channels per output tile
constexpr int KC = 32;   // depth of one shared-memory chunk
constexpr int NT = 256;  // threads per block: 16 x 16 threads of 4x4 tiles

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// acc[i][j] += sum_kk a[kk][ty*4+i] * b[kk][tx*4+j] over one KC chunk
__device__ __forceinline__ void fma_chunk(const float* a, int lda,
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

size_t f32_smem_bytes(int n) {
  const int npad = (n + TK - 1) / TK * TK;
  return sizeof(float) * (size_t)(npad * TQ + KC * TQ + KC * TK + 4 * TQ);
}

__global__ void __launch_bounds__(NT)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int n, int c, float scale) {
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
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* ob = o + base;

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
      fma_chunk(as, TQ, bs, TK, ty, tx, acc);
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
      fma_chunk(st + k0 * TQ, TQ, bs, TK, ty, tx, acc);
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

int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + TQ - 1) / TQ, b);
  attention_f32_kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, c, scale);
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
  if (dtype == 0) return launch_f32(q, k, v, o, b, n, c, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // key tiles, a compile-time count; one warpgroup of query rows where
  // one key tile holds every token, two (K and V read half as often)
  // otherwise
  switch ((n + BK - 1) / BK) {
    case 1: return launch_bf16<1, 1>(q, k, v, o, b, n, c, scale, s);
    case 2: return launch_bf16<2, 2>(q, k, v, o, b, n, c, scale, s);
    case 3: return launch_bf16<3, 2>(q, k, v, o, b, n, c, scale, s);
    default: return launch_bf16<4, 2>(q, k, v, o, b, n, c, scale, s);
  }
}

const char* psld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
