// GroupNorm + activation, backward, split entry points, for Hopper
// (sm_90a). The gradient and the gn_bf16 chain are those of
// csrc/group_norm_bwd.cu (its source note says what each rounds); a
// library of its own so that nvcc builds it beside the fused kernels.
//
// Split entry points, for an image whose height is split over the ranks
// of a spatial group (psld_tpu_torch/parallel/spatial.py), from the
// global sums of x and x^2 the forward saved (no moment is recomputed
// from the local pixels); they launch only under spatial parallelism:
//   - psld_gn_split_partials writes each (n, group)'s f32 sums P1 =
//     sum(dd) and P2 = sum(dxh * d) over the local pixels, with d = x -
//     mean, dxh = dz * scale and dd = dxh * rstd (under gn_bf16, the
//     chain's roundings of each), into an (N, G, 2) buffer, and dscale
//     = sum(dz * xh) and dbias = sum(dz) over the local pixels of the
//     whole batch. The host all-reduces the (N, G, 2) sums over the
//     group; dscale and dbias enter the training step's gradient
//     reduction;
//   - psld_gn_split_dx computes dx = dd + (-P1 + 2 d dvar) / n with
//     dvar = -rstd^3 P2 / 2 (0 where the variance was clamped); under
//     gn_bf16, dx = bf16(dd + bf16(the f32 term)), as autograd through
//     the plain chain rounds it.
// Bound: partials read x and g, dx reads them again and writes dx: four
// reads and one write, some 30 f32 operations an element.
//
// The partials' design follows psld_gn_split_stats's (csrc/
// group_norm_fwd.cu): a block of 256 threads owns a chunk of pixel rows
// of one batch element (ops/group_norm.py::plan_split_partials sizes it:
// one wave of two blocks an SM over a large shard, one block a batch
// element of up to 128 KB of x). A thread owns one 16-byte piece of a row
// of x and of g (8 bf16 or 4 f32 channels; one channel, up to four of
// them, where C is no multiple of the piece), computes its channels'
// mean, rstd, scale and bias once, and keeps the four sums of each
// channel (dz * xh, dz, dd, dxh * d) in registers over the rows RY apart,
// PART_UNROLL rows in flight. The rows are folded by shuffles and in
// shared memory in slot order, dd and dxh * d into groups in channel
// order, and the block writes its chunk's (P1, P2) a group and (dscale,
// dbias) a channel. The last block of a batch element to finish (a
// __threadfence and a counter in done[n]) adds the element's chunks in
// chunk order: (P1, P2) straight into p, the channels into one (dscale,
// dbias) row of the element; the last element to finish (counter
// done[B]) adds the B rows in batch order into dscale and dbias. Every
// fold gives an item a few lanes, each adding a run of the entries in
// order, then a fixed shuffle tree: no atomics on the sums, so two
// launches are bit for bit equal, and a call is one launch. A batch
// element of one chunk writes p directly (and, at B = 1, dscale and
// dbias).
//
// dx's design: a 2D grid of (pixel tiles, batch element), no division an
// element. A thread owns one 16-byte piece of a row (the scalar path as
// above) and computes its channels' constants once: mean, rstd, dvar,
// scale, bias and P1; it loads x and g and stores dx 16 bytes at a time,
// DX_UNROLL rows in flight, DX_PASSES passes over its tile.
//
// What holds them back (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's
// [spatial_kernels], the 105 calls of a CelebA-HQ 256 rank backward at
// B=8, bf16 gn_bf16): dx runs at 0.72 of its bytes bound. The partials run
// at 0.44: on the shards of 8,192 to 32,768 pixels at 0.65, where the
// chain (~34 instructions an element in bf16 pairs, against 4 bytes) is
// issue-bound; the 62 calls of 8 to 512 pixels take 7.5 to 17 us each, a
// chain of latencies (the loads, the block's reduction, one or two folds
// through L2). PERF.md section 6 lists what was tried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "group_norm_bwd.cuh"

namespace {

constexpr int SPLIT_THREADS = 256;
// pixel rows a thread has in flight, each a 16-byte load of x and one of
// g: the partials' (the planner, ops/group_norm.py::_PART_UNROLL, makes
// a chunk a multiple of the pass, SPLIT_THREADS / pieces * PART_UNROLL
// rows, and the entry refuses a chunk that is not) and dx's
constexpr int PART_UNROLL = 4;
constexpr int DX_UNROLL = 4;
// passes of DX_UNROLL rows a thread of dx makes over a tile of a large
// shard, and the blocks below which dx's tiles shrink (down to one row a
// thread) to spread a small shard over more SMs
constexpr int DX_PASSES = 2;
constexpr int DX_BLOCKS = 264;
// blocks of 256 threads an SM the register budget of each kernel allows
// (three spill: PERF.md section 6)
constexpr int SPLIT_RESIDENT = 2;
// loads in flight a thread of the partials' folds
constexpr int FOLD_FLIGHT = 8;
// floats of each of the partials' four channel-sum buffers: slots x C
constexpr int PART_SLOTS = 2048;

template <typename T>
__device__ __forceinline__ float elem_f(T v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T to_elem(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __float2bfloat16_rn(v);
}

// 16 bytes of T as N floats, and back
template <typename T>
struct Wide;

template <>
struct Wide<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Wide<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = psld::unpack_bf16(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(psld::pack_bf16(f[0], f[1]), psld::pack_bf16(f[2], f[3]),
                      psld::pack_bf16(f[4], f[5]), psld::pack_bf16(f[6], f[7]));
  }
};

// V channels of T at p: one 16-byte access (V = Wide<T>::N), or one
// scalar (V = 1, the path of a C that is no multiple of the piece)
template <typename T, int V>
struct Access {
  using Raw = uint4;
  __device__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(const Raw& r, float* f) {
    Wide<T>::unpack(r, f);
  }
  __device__ static void store(T* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = Wide<T>::pack(f);
  }
};

template <typename T>
struct Access<T, 1> {
  using Raw = float;
  __device__ static Raw load(const T* p) { return elem_f(__ldg(p)); }
  __device__ static Raw zero() { return 0.f; }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = r; }
  __device__ static void store(T* p, const float* f) { *p = to_elem<T>(f[0]); }
};

struct Moments {
  float mean, rs, dvar_scale;   // dvar_scale: -rstd^3 / 2, 0 if clamped
};

__device__ __forceinline__ Moments moments_of(const float* sm, float inv_n,
                                              float eps) {
  const float mean = sm[0] * inv_n;
  const float raw = sm[1] * inv_n - mean * mean;
  const float rs = rsqrtf(fmaxf(raw, 0.f) + eps);
  return {mean, rs, raw >= 0.f ? -0.5f * rs * rs * rs : 0.f};
}

// a channel's constants of the chain: mean, rstd, scale and bias, each
// rounded to bf16 under CHAIN (the gn_bf16 chain's mb, rb, sb, bb)
template <bool CHAIN>
__device__ __forceinline__ void chain_consts(const Moments& m, float sc,
                                             float bi, float& mu, float& rs,
                                             float& s, float& b) {
  mu = CHAIN ? bf16r(m.mean) : m.mean;
  rs = CHAIN ? bf16r(m.rs) : m.rs;
  s = CHAIN ? bf16r(sc) : sc;
  b = CHAIN ? bf16r(bi) : bi;
}

// the chain of one element from its channel's chain_consts: d = x - mean,
// dz, dxh = dz * scale, dd = dxh * rstd and xh, with the gn_bf16
// roundings under CHAIN
template <int ACT, bool CHAIN>
__device__ __forceinline__ void split_chain(float v, float gv, float mu,
                                            float rs, float sc, float bi,
                                            float& d, float& xh, float& dz,
                                            float& dxh, float& dd) {
  if (CHAIN) {
    d = bf16r(v - mu);
    xh = bf16r(d * rs);
    const float z = bf16r(bf16r(xh * sc) + bi);
    dz = bf16r(dz_of<ACT>(gv, z));
    dxh = bf16r(dz * sc);
    dd = bf16r(dxh * rs);
  } else {
    d = v - mu;
    xh = d * rs;
    dz = dz_of<ACT>(gv, xh * sc + bi);
    dxh = dz * sc;
    dd = dxh * rs;
  }
}

// split_chain's gn_bf16 chain of a pair of channels (two bf16 in 32 bits)
// in bf16 pair arithmetic, each operation rounded once as PyTorch's bf16
// operations computed in f32 and rounded are; mu, rs, sc, bi are the
// pairs of chain_consts
template <int ACT>
__device__ __forceinline__ void split_chain_pair(uint32_t x, uint32_t g,
                                                 uint32_t mu, uint32_t rs,
                                                 uint32_t sc, uint32_t bi,
                                                 uint32_t& d, uint32_t& xh,
                                                 uint32_t& dz, uint32_t& dxh,
                                                 uint32_t& dd) {
  d = psld::sub_bf16x2(x, mu);
  xh = psld::mul_bf16x2(d, rs);
  const float2 z =
      psld::unpack_bf16(psld::add_bf16x2(psld::mul_bf16x2(xh, sc), bi));
  const float2 gf = psld::unpack_bf16(g);
  dz = psld::pack_bf16(dz_of<ACT>(gf.x, z.x), dz_of<ACT>(gf.y, z.y));
  dxh = psld::mul_bf16x2(dz, sc);
  dd = psld::mul_bf16x2(dxh, rs);
}

__device__ __forceinline__ void store_param(void* p, int bf16, int i,
                                            float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// whether this block is the last of `total` to reach it: a __threadfence,
// then the count in *counter (the last block sees every other block's
// writes)
__device__ __forceinline__ bool last_to_finish(int* counter, int total,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == total - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// in one block: item i of `items` summed over `count` float2 entries
// src[k * stride + i], k in order: LN lanes an item, lane l adding the
// entries [l * K, (l + 1) * K) in order with FOLD_FLIGHT loads in flight,
// the lanes
// added by a fixed shuffle tree. Item i < split goes to pairs[i]; item
// split + j (a channel) to rows[j], or with rows null to dscale[j] and
// dbias[j] in the parameters' types.
__device__ void fold_pairs(const float2* src, int items, int count,
                           size_t stride, int split, float2* pairs,
                           float2* rows, void* dscale, int scale_bf16,
                           void* dbias, int bias_bf16) {
  int ln = 1;
  while (ln < 32 && 2 * ln * items <= SPLIT_THREADS) ln *= 2;
  const int per = (count + ln - 1) / ln;
  for (int i0 = 0; i0 < items; i0 += SPLIT_THREADS / ln) {
    const int i = i0 + (int)threadIdx.x / ln, l = (int)threadIdx.x % ln;
    float a = 0.f, b = 0.f;
    if (i < items) {
      const int k1 = min(count, (l + 1) * per);
      for (int k0 = l * per; k0 < k1; k0 += FOLD_FLIGHT) {
        float2 v[FOLD_FLIGHT];
#pragma unroll
        for (int j = 0; j < FOLD_FLIGHT; ++j)
          v[j] = k0 + j < k1 ? __ldcg(src + (size_t)(k0 + j) * stride + i)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < FOLD_FLIGHT; ++j) {
          a += v[j].x;
          b += v[j].y;
        }
      }
    }
    for (int off = ln / 2; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (i < items && l == 0) {
      if (i < split) {
        pairs[i] = make_float2(a, b);
      } else if (rows != nullptr) {
        rows[i - split] = make_float2(a, b);
      } else {
        store_param(dscale, scale_bf16, i - split, a);
        store_param(dbias, bias_bf16, i - split, b);
      }
    }
  }
}

// block (chunk, n): per channel sums of dz * xh, dz, dd and dxh * d over
// pixels [chunk * rows, +rows) of batch element n. A thread owns V
// channels of a row (KP pieces of them on the scalar path) and the rows
// RY apart, PART_UNROLL of them in flight; the channels' constants are
// computed once (as bf16 pairs under the gn_bf16 chain, which runs in
// pair arithmetic), the sums kept in f32 registers, the rows folded by
// warp shuffles (where a warp holds several) and in shared memory in slot
// order, then dd and dxh * d into groups. Scratch (part): [B][nch][G + C]
// float2, each chunk's (P1, P2) a group then (dscale, dbias) a channel,
// with more than one chunk; then [B][C] (dscale, dbias) of each batch
// element, with more than one batch element.
// One chunk: the block writes p[n] and its channel row (B = 1: dscale,
// dbias). Else the last block of batch element n (counted in done[n])
// adds the chunks' partials in chunk order, in one pass, into p[n] and
// the element's channel row (B = 1: dscale, dbias). With B > 1 the last
// batch element (counted in done[B]) adds the B rows in batch order into
// dscale and dbias. Counts are left at 0.
template <typename T, int V, int ACT, bool CHAIN>
__global__ void __launch_bounds__(SPLIT_THREADS, SPLIT_RESIDENT)
gn_split_partials_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ sums,
                         const void* __restrict__ scale, int scale_bf16,
                         const void* __restrict__ bias, int bias_bf16,
                         float* __restrict__ part, int* __restrict__ done,
                         float* __restrict__ p, void* __restrict__ dscale,
                         void* __restrict__ dbias, int hw, int c, int cgrp,
                         int rows, float inv_n, float eps) {
  using A = Access<T, V>;
  constexpr int KP = V == 1 ? 1024 / SPLIT_THREADS : 1;
  constexpr int U = PART_UNROLL;
  constexpr bool PAIRS = CHAIN && V > 1;   // the chain in bf16 pairs
  constexpr int NP = PAIRS ? V / 2 : 1;
  __shared__ float sh[4][PART_SLOTS];
  __shared__ int flag;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int nch = gridDim.x, nb = gridDim.y;
  const int tid = threadIdx.x;
  const int ng = c / cgrp;
  const int pieces = c / V;
  const int tx_n = pieces < SPLIT_THREADS ? pieces : SPLIT_THREADS;
  const int ry = SPLIT_THREADS / tx_n;
  const int tx = tid % tx_n, ty = tid / tx_n;
  const int p0 = chunk * rows;
  const int p1 = min(hw, p0 + rows);
  const T* xb = x + (size_t)n * hw * c;
  const T* gb = g + (size_t)n * hw * c;
  float mu[KP][V], rs[KP][V], sc[KP][V], bi[KP][V];
  float s0[KP][V], s1[KP][V], s2[KP][V], s3[KP][V];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int ch = min((tx + k * tx_n) * V + v, c - 1);
      chain_consts<CHAIN>(
          moments_of(sums + ((size_t)n * ng + ch / cgrp) * 2, inv_n, eps),
          load_param(scale, scale_bf16, ch), load_param(bias, bias_bf16, ch),
          mu[k][v], rs[k][v], sc[k][v], bi[k][v]);
      s0[k][v] = s1[k][v] = s2[k][v] = s3[k][v] = 0.f;
    }
  uint32_t mu2[NP], rs2[NP], sc2[NP], bi2[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    mu2[j] = psld::pack_bf16(mu[0][2 * j], mu[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
    rs2[j] = psld::pack_bf16(rs[0][2 * j], rs[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
    sc2[j] = psld::pack_bf16(sc[0][2 * j], sc[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
    bi2[j] = psld::pack_bf16(bi[0][2 * j], bi[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
  }
  // a pixel past the chunk or a piece past C loads zeros: its cotangent
  // 0 adds 0 to every sum (loading the first rows before the constants,
  // as dx does, made the partials slower on the card)
  if (ty < ry) {
    for (int r = p0 + ty; r < p1; r += ry * U) {
      typename A::Raw rx[U][KP], rg[U][KP];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int row = r + u * ry, pc = tx + k * tx_n;
          const bool ok = row < p1 && pc < pieces;
          const size_t off = (size_t)row * c + (size_t)pc * V;
          rx[u][k] = ok ? A::load(xb + off) : A::zero();
          rg[u][k] = ok ? A::load(gb + off) : A::zero();
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if constexpr (PAIRS) {
            const uint32_t* wx = reinterpret_cast<const uint32_t*>(&rx[u][k]);
            const uint32_t* wg = reinterpret_cast<const uint32_t*>(&rg[u][k]);
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              uint32_t d, xh, dz, dxh, dd;
              split_chain_pair<ACT>(wx[j], wg[j], mu2[j], rs2[j], sc2[j],
                                    bi2[j], d, xh, dz, dxh, dd);
              const float2 a = psld::unpack_bf16(psld::mul_bf16x2(dz, xh));
              const float2 fz = psld::unpack_bf16(dz);
              const float2 fdd = psld::unpack_bf16(dd);
              const float2 fh = psld::unpack_bf16(dxh);
              const float2 fd = psld::unpack_bf16(d);
              s0[k][2 * j] += a.x;
              s0[k][2 * j + 1] += a.y;
              s1[k][2 * j] += fz.x;
              s1[k][2 * j + 1] += fz.y;
              s2[k][2 * j] += fdd.x;
              s2[k][2 * j + 1] += fdd.y;
              s3[k][2 * j] = fmaf(fh.x, fd.x, s3[k][2 * j]);
              s3[k][2 * j + 1] = fmaf(fh.y, fd.y, s3[k][2 * j + 1]);
            }
          } else {
            float fx[V], fg[V];
            A::unpack(rx[u][k], fx);
            A::unpack(rg[u][k], fg);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float d, xh, dz, dxh, dd;
              split_chain<ACT, CHAIN>(fx[v], fg[v], mu[k][v], rs[k][v],
                                      sc[k][v], bi[k][v], d, xh, dz, dxh,
                                      dd);
              s0[k][v] += CHAIN ? bf16r(dz * xh) : dz * xh;
              s1[k][v] += dz;
              s2[k][v] += dd;
              s3[k][v] = fmaf(dxh, d, s3[k][v]);
            }
          }
        }
    }
  }
  // rows -> slots: a warp that holds 32 / tx_n rows folds them with
  // shuffles into one slot; else each row is a slot
  const bool shuffle = tx_n < 32 && 32 % tx_n == 0;
  if (shuffle) {
    for (int off = 16; off >= tx_n; off >>= 1)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s0[0][v] += __shfl_xor_sync(0xffffffffu, s0[0][v], off);
        s1[0][v] += __shfl_xor_sync(0xffffffffu, s1[0][v], off);
        s2[0][v] += __shfl_xor_sync(0xffffffffu, s2[0][v], off);
        s3[0][v] += __shfl_xor_sync(0xffffffffu, s3[0][v], off);
      }
  }
  const int slots = shuffle ? SPLIT_THREADS / 32 : ry;
  const int slot = shuffle ? tid / 32 : ty;
  if (shuffle ? tid % 32 < tx_n : ty < ry) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int pc = tx + k * tx_n;
      if (pc < pieces)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int i = slot * c + pc * V + v;
          sh[0][i] = s0[k][v];
          sh[1][i] = s1[k][v];
          sh[2][i] = s2[k][v];
          sh[3][i] = s3[k][v];
        }
    }
  }
  __syncthreads();
  // slots -> channels, in slot order, into slot 0
  for (int ch = tid; ch < c; ch += SPLIT_THREADS) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < slots; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] += sh[j][r * c + ch];
#pragma unroll
    for (int j = 0; j < 4; ++j) sh[j][ch] = a[j];
  }
  __syncthreads();
  const int items = ng + c;   // a chunk's (P1, P2) pairs, then its channels'
  float2* cpart = reinterpret_cast<float2*>(part);
  float2* crow = cpart + (nch > 1 ? (size_t)nb * nch * items : 0);
  float2* pn = reinterpret_cast<float2*>(p) + (size_t)n * ng;
  float2* mine = cpart + ((size_t)n * nch + chunk) * items;
  // channels -> groups, in channel order: (P1, P2)
  for (int gi = tid; gi < ng; gi += SPLIT_THREADS) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cgrp; ++j) {
      a += sh[2][gi * cgrp + j];
      b += sh[3][gi * cgrp + j];
    }
    (nch == 1 ? pn : mine)[gi] = make_float2(a, b);
  }
  for (int ch = tid; ch < c; ch += SPLIT_THREADS) {
    const float2 v = make_float2(sh[0][ch], sh[1][ch]);
    if (nch > 1) {
      mine[ng + ch] = v;
    } else if (nb > 1) {
      crow[(size_t)n * c + ch] = v;
    } else {
      store_param(dscale, scale_bf16, ch, v.x);
      store_param(dbias, bias_bf16, ch, v.y);
    }
  }
  if (nch > 1) {
    if (!last_to_finish(done + n, nch, &flag)) return;
    // the batch element's chunks, in chunk order: (P1, P2) into p[n],
    // the channels into its row
    fold_pairs(cpart + (size_t)n * nch * items, items, nch, items, ng, pn,
               nb > 1 ? crow + (size_t)n * c : nullptr, dscale, scale_bf16,
               dbias, bias_bf16);
    if (tid == 0) done[n] = 0;
  }
  if (nb == 1 || !last_to_finish(done + nb, nb, &flag)) return;
  // the batch elements' rows, in batch order
  fold_pairs(crow, c, nb, c, 0, nullptr, nullptr, dscale, scale_bf16, dbias,
             bias_bf16);
  if (tid == 0) done[nb] = 0;
}

// block (tile, n): dx of pixels [tile * rows, +rows) of batch element n
// from the global sums and the global (P1, P2). A thread owns V channels
// of a row (KP pieces of them on the scalar path) and computes their
// constants once: mean, rstd, dvar = -rstd^3 P2 / 2 (0 where the variance
// was clamped), scale, bias and P1; it has DX_UNROLL rows in flight,
// loads x and g and stores dx 16 bytes at a time; under the gn_bf16
// chain it runs in bf16 pairs.
template <typename T, int V, int ACT, bool CHAIN>
__global__ void __launch_bounds__(SPLIT_THREADS, SPLIT_RESIDENT)
gn_split_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, const float* __restrict__ sums,
                   const float* __restrict__ p,
                   const void* __restrict__ scale, int scale_bf16,
                   const void* __restrict__ bias, int bias_bf16, int hw,
                   int c, int cgrp, int rows, float inv_n, float eps) {
  using A = Access<T, V>;
  constexpr int KP = V == 1 ? 1024 / SPLIT_THREADS : 1;
  constexpr int U = DX_UNROLL;
  constexpr bool PAIRS = CHAIN && V > 1;
  constexpr int NP = PAIRS ? V / 2 : 1;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int ng = c / cgrp;
  const int pieces = c / V;
  const int tx_n = pieces < SPLIT_THREADS ? pieces : SPLIT_THREADS;
  const int ry = SPLIT_THREADS / tx_n;
  const int tx = tid % tx_n, ty = tid / tx_n;
  if (ty >= ry) return;
  const int p0 = blockIdx.x * rows;
  const int p1 = min(hw, p0 + rows);
  const size_t base = (size_t)n * hw * c;
  const T* xb = x + base;
  const T* gb = g + base;
  T* db = dx + base;
  typename A::Raw rx[U][KP], rg[U][KP];
  auto load_rows = [&](int r) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int row = r + u * ry, pc = tx + k * tx_n;
        const bool ok = row < p1 && pc < pieces;
        const size_t off = (size_t)row * c + (size_t)pc * V;
        rx[u][k] = ok ? A::load(xb + off) : A::zero();
        rg[u][k] = ok ? A::load(gb + off) : A::zero();
      }
  };
  // the first rows go out before the constants' loads
  load_rows(p0 + ty);
  float mu[KP][V], rs[KP][V], sc[KP][V], bi[KP][V];
  float mean[KP][V], dvar[KP][V], p1s[KP][V];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int ch = min((tx + k * tx_n) * V + v, c - 1);
      const size_t gi = ((size_t)n * ng + ch / cgrp) * 2;
      const Moments m = moments_of(sums + gi, inv_n, eps);
      chain_consts<CHAIN>(m, load_param(scale, scale_bf16, ch),
                          load_param(bias, bias_bf16, ch), mu[k][v],
                          rs[k][v], sc[k][v], bi[k][v]);
      mean[k][v] = m.mean;
      dvar[k][v] = m.dvar_scale * p[gi + 1];
      p1s[k][v] = p[gi];
    }
  uint32_t mu2[NP], rs2[NP], sc2[NP], bi2[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    mu2[j] = psld::pack_bf16(mu[0][2 * j], mu[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
    rs2[j] = psld::pack_bf16(rs[0][2 * j], rs[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
    sc2[j] = psld::pack_bf16(sc[0][2 * j], sc[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
    bi2[j] = psld::pack_bf16(bi[0][2 * j], bi[0][2 * j + 1 < V ? 2 * j + 1 : 0]);
  }
  for (int r = p0 + ty; r < p1; r += ry * U) {
    if (r != p0 + ty) load_rows(r);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int row = r + u * ry, pc = tx + k * tx_n;
        if (row >= p1 || pc >= pieces) continue;
        T* out = db + (size_t)row * c + (size_t)pc * V;
        if constexpr (PAIRS) {
          const uint32_t* wx = reinterpret_cast<const uint32_t*>(&rx[u][k]);
          const uint32_t* wg = reinterpret_cast<const uint32_t*>(&rg[u][k]);
          uint32_t o[NP];
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            uint32_t d, xh, dz, dxh, dd;
            split_chain_pair<ACT>(wx[j], wg[j], mu2[j], rs2[j], sc2[j],
                                  bi2[j], d, xh, dz, dxh, dd);
            const float2 fx = psld::unpack_bf16(wx[j]);
            const float c0 = (2.f * (fx.x - mean[k][2 * j]) *
                                  dvar[k][2 * j] - p1s[k][2 * j]) * inv_n;
            const float c1 = (2.f * (fx.y - mean[k][2 * j + 1]) *
                                  dvar[k][2 * j + 1] - p1s[k][2 * j + 1]) *
                             inv_n;
            o[j] = psld::add_bf16x2(dd, psld::pack_bf16(c0, c1));
          }
          *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
          float fx[V], fg[V], o[V];
          A::unpack(rx[u][k], fx);
          A::unpack(rg[u][k], fg);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float d, xh, dz, dxh, dd;
            split_chain<ACT, CHAIN>(fx[v], fg[v], mu[k][v], rs[k][v],
                                    sc[k][v], bi[k][v], d, xh, dz, dxh, dd);
            const float corr =
                (2.f * (fx[v] - mean[k][v]) * dvar[k][v] - p1s[k][v]) * inv_n;
            o[v] = CHAIN ? bf16r(dd + bf16r(corr)) : dd + corr;
          }
          A::store(out, o);
        }
      }
  }
}

template <typename T, int V, bool CHAIN>
int split_partials(int act, const void* x, const void* g, const float* sums,
                   const void* scale, int sbf, const void* bias, int bbf,
                   float* part, int* done, float* p, void* dscale,
                   void* dbias, int b, int hw, int c, int cgrp, int rows,
                   float inv_n, float eps, cudaStream_t st) {
  const dim3 grid((unsigned)(((long long)hw + rows - 1) / rows), b);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
#define PSLD_PART(A)                                                         \
  gn_split_partials_kernel<T, V, A, CHAIN><<<grid, SPLIT_THREADS, 0, st>>>( \
      xt, gt, sums, scale, sbf, bias, bbf, part, done, p, dscale, dbias,    \
      hw, c, cgrp, rows, inv_n, eps);                                       \
  break
  switch (act) {
    case 0: PSLD_PART(0);
    case 1: PSLD_PART(1);
    case 2: PSLD_PART(2);
    case 3: PSLD_PART(3);
    case 4: PSLD_PART(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PSLD_PART
  return (int)cudaGetLastError();
}

template <typename T, int V, bool CHAIN>
int split_dx(int act, const void* x, const void* g, void* dx,
             const float* sums, const float* p, const void* scale, int sbf,
             const void* bias, int bbf, int b, int hw, int c, int cgrp,
             float inv_n, float eps, cudaStream_t st) {
  const int pieces = c / V;
  const int ry = SPLIT_THREADS / (pieces < SPLIT_THREADS ? pieces
                                                         : SPLIT_THREADS);
  int rows = ry * DX_UNROLL * DX_PASSES;
  if (((long long)hw + rows - 1) / rows * b < DX_BLOCKS) {
    // a small shard: tiles of fewer rows (at least one a thread), so that
    // its blocks spread over more SMs
    const long long want = ((long long)hw * b + DX_BLOCKS - 1) / DX_BLOCKS;
    rows = (int)((want + ry - 1) / ry * ry);
  }
  const dim3 grid((unsigned)(((long long)hw + rows - 1) / rows), b);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
#define PSLD_DX(A)                                                           \
  gn_split_dx_kernel<T, V, A, CHAIN><<<grid, SPLIT_THREADS, 0, st>>>(       \
      xt, gt, dt, sums, p, scale, sbf, bias, bbf, hw, c, cgrp, rows, inv_n, \
      eps);                                                                 \
  break
  switch (act) {
    case 0: PSLD_DX(0);
    case 1: PSLD_DX(1);
    case 2: PSLD_DX(2);
    case 3: PSLD_DX(3);
    case 4: PSLD_DX(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PSLD_DX
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

}  // namespace

extern "C" {

// (B, H*W, C) NHWC x and cotangent g (this rank's rows), the global sums
// (B, C / cgrp, 2) f32 of the forward over n elements a group -> p (B, C
// / cgrp, 2) f32, the local (P1, P2), and dscale, dbias (C,) in the
// parameters' types over the local pixels of the batch; one launch.
// rows: pixels a block reduces (ops/group_norm.py::plan_split_partials),
// with more than one chunk a multiple of the pass (SPLIT_THREADS /
// (C / vec, at most SPLIT_THREADS) * PART_UNROLL rows);
// vec: the channels a load, 16 / sizeof(T) (C a multiple of it, x and g
// on 16-byte boundaries) or 1. part holds, with nch = ceil(H*W / rows)
// > 1 chunks, B * nch * (C / cgrp + C) * 2 floats, and with B > 1
// another B * C * 2 (null where neither); done B + 1 ints at 0 (null
// where nch = 1 and B = 1), which the launch leaves at 0. dtype: 0 =
// float32, 1 = bfloat16; chain: 1 = the gn_bf16 chain (bfloat16 only).
// Returns a cudaError_t.
int psld_gn_split_partials(const void* x, const void* g, const void* sums,
                           const void* scale, int scale_bf16,
                           const void* bias, int bias_bf16, void* part,
                           void* done, void* p, void* dscale, void* dbias,
                           int b, int hw, int c, int cgrp, float n, int act,
                           int chain, float eps, int rows, int vec,
                           int dtype, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || (chain && dtype != 1) || b < 1 ||
      b > 65535 || hw < 1 || c < 1 || c > 1024 || cgrp < 1 || c % cgrp ||
      !(n > 0.f) || rows < 1 || (vec != 1 && vec != wide) || c % vec ||
      (vec != 1 && !aligned16(x, g, nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long nch = ((long long)hw + rows - 1) / rows;
  const int pieces = c / vec;
  const int pass = SPLIT_THREADS / (pieces < SPLIT_THREADS ? pieces
                                                          : SPLIT_THREADS)
                   * PART_UNROLL;
  if ((nch > 1 && rows % pass) ||
      ((nch > 1 || b > 1) && (part == nullptr || done == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sm = static_cast<const float*>(sums);
  float* pt = static_cast<float*>(part);
  int* dn = static_cast<int*>(done);
  float* pp = static_cast<float*>(p);
  const float inv_n = 1.f / n;
#define PSLD_SPLIT(T, V, CH)                                                 \
  return split_partials<T, V, CH>(act, x, g, sm, scale, scale_bf16, bias,    \
                                  bias_bf16, pt, dn, pp, dscale, dbias, b,   \
                                  hw, c, cgrp, rows, inv_n, eps, st)
  if (dtype == 0 && vec == 1) PSLD_SPLIT(float, 1, false);
  if (dtype == 0) PSLD_SPLIT(float, 4, false);
  if (chain && vec == 1) PSLD_SPLIT(__nv_bfloat16, 1, true);
  if (chain) PSLD_SPLIT(__nv_bfloat16, 8, true);
  if (vec == 1) PSLD_SPLIT(__nv_bfloat16, 1, false);
  PSLD_SPLIT(__nv_bfloat16, 8, false);
#undef PSLD_SPLIT
}

// dx (x's type) from x, g, the global sums and the global (P1, P2) (B, C
// / cgrp, 2) f32 over n elements a group; 16-byte accesses where C is a
// multiple of 16 / sizeof(T) and x, g and dx lie on 16-byte boundaries,
// else one channel an access. Returns a cudaError_t.
int psld_gn_split_dx(const void* x, const void* g, void* dx,
                     const void* sums, const void* p, const void* scale,
                     int scale_bf16, const void* bias, int bias_bf16, int b,
                     int hw, int c, int cgrp, float n, int act, int chain,
                     float eps, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (chain && dtype != 1) || b < 1 ||
      b > 65535 || hw < 1 || c < 1 || c > 1024 || cgrp < 1 || c % cgrp ||
      !(n > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sm = static_cast<const float*>(sums);
  const float* pp = static_cast<const float*>(p);
  const float inv_n = 1.f / n;
  const bool wide = c % (dtype == 0 ? 4 : 8) == 0 && aligned16(x, g, dx);
#define PSLD_SPLIT(T, V, CH)                                                 \
  return split_dx<T, V, CH>(act, x, g, dx, sm, pp, scale, scale_bf16, bias,  \
                            bias_bf16, b, hw, c, cgrp, inv_n, eps, st)
  if (dtype == 0 && !wide) PSLD_SPLIT(float, 1, false);
  if (dtype == 0) PSLD_SPLIT(float, 4, false);
  if (chain && !wide) PSLD_SPLIT(__nv_bfloat16, 1, true);
  if (chain) PSLD_SPLIT(__nv_bfloat16, 8, true);
  if (!wide) PSLD_SPLIT(__nv_bfloat16, 1, false);
  PSLD_SPLIT(__nv_bfloat16, 8, false);
#undef PSLD_SPLIT
}

const char* psld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
