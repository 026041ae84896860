// GroupNorm + activation, forward, for Hopper (sm_90a).
//
// Replaces psld_tpu/ops/group_norm.py::_gn_kernel (launched by _pallas_gn):
// NHWC GroupNorm(G) + affine + act, y = act((x - mean) * rstd * scale +
// bias), with single-pass f32 moments, the variance clamped at 0 and
// rsqrt(var + eps); mean as the sum times 1 / n, as PyTorch's mean takes
// it. Two chains:
//   - the f32 chain (the TPU kernel's): everything in f32, one rounding to
//     the output dtype;
//   - under gn_bf16 with bf16 x (CHAIN), the chain of the port's plain
//     version and of psld_tpu's group_norm_act_reference: mean and rstd
//     rounded to bf16, then (x - mean), * rstd, * scale, + bias each
//     rounded to bf16 (bf16 pair arithmetic, one rounding of the exact
//     result, as PyTorch's bf16 operations computed in f32 give), then the
//     activation in f32, rounded once. Sums in another order can move a
//     group's mean or rstd across a bf16 rounding boundary, so a group may
//     differ from the plain version by one bf16 step (none did at the
//     smoke's shapes).
// The host reads the knob at every call and passes the chain as a flag.
//
// What bounds it on the H100: device-memory bytes. Per element it is ~12
// f32 operations against one read of x and one write of y; at (64, 32,
// 32, 256) bf16 that is 67 MB, 20 us at 3.35 TB/s.
//
// Design: every byte of x is read from device memory once and y is
// written once. A block of 128 or 256 threads (a cluster of 1 to 8 such
// blocks where one block's third of an SM's shared memory cannot hold the
// pixels) owns one work item: one batch element's slice of S channels,
// whole groups, S * sizeof(T) a multiple of 16 bytes and at most one
// 128-byte line of an NHWC row where a slice of whole groups allows. The
// host planner (ops/group_norm.py::plan_forward) picks S, the cluster,
// the threads and the resident rows from (H*W, C, G, dtype, batch): three
// blocks share an SM, slices a multiple of 32 bytes (whole sectors) come
// first, and 64-byte slices where 128-byte ones would leave fewer than
// 512 work items. A thread owns one 16-byte piece of the row (8 bf16 or 4
// f32 channels) and the rows r, r + R, ... of its run: it stages exactly
// the pieces it will reduce and normalize with 16-byte cp.async in four
// commit groups, and adds the f32 sums of x and x^2 of each group as soon
// as it has landed, while the later ones are still in flight. A thread
// reads back only what it copied, so the staging needs no barrier. The
// sums are folded over the rows of a warp with shuffles, over the warps
// of the block in shared memory, over the blocks of a cluster through
// distributed shared memory in rank order (so the result is
// deterministic), then into groups. The normalize pass reads the pieces
// back from shared memory and writes y with 16-byte stores. Where a run
// is longer than shared memory holds (H*W of 16,384 and more at some
// widths), the rows past the resident ones are read from device memory in
// both passes.
//
// Maps of up to 64 pixels take gn_fwd_warp_kernel instead: a warp owns a
// work item and holds its pieces in registers, so its chain of loads,
// sums and stores has no barrier; at these shapes the chain is latency,
// not bytes.
//
// Tried on the card and dropped (PERF.md, section 6): blocks that
// walk several work items with a second buffer (a fifth to a half
// slower), holding part of a run and re-reading the rest (slower at
// every share), clusters splitting a 1024-pixel run (slower than a block
// alone), unrolling the row loops 1 to 4 times (within 3%).
//
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's [gn]
// rows): at H*W = 1024 a launch is 1.3 waves of three blocks an SM, and
// a block stages, reduces, then writes, so the first wave loads, then
// stores, with little overlap between the two: 60-79% of the bytes bound
// there. At H*W of 256 and below every block runs at once and the chain
// of one block's loads, barriers and stores is the time.
//
// ptxas (sm_90a, nvcc 12.8): the block kernels 56-72 registers, the warp
// kernel 64-117, no spills, no stack. Shared memory is dynamic, the run
// plus 4 * (2 * NT / 32 * S + 8 * S) bytes: 68,608 for 1024 pixels of 32
// bf16 channels in 256 threads, so three blocks share an SM.
//
// Split entry points, for an image whose height is split over the ranks
// of a spatial group (psld_tpu_torch/parallel/spatial.py); they launch
// only under spatial parallelism, where the moments span the shards:
//   - psld_gn_split_stats writes each (n, group)'s f32 sums of x and x^2
//     over the local pixels into an (N, G, 2) buffer: the channel sums
//     the fused kernel adds, folded into groups, in one launch. The host
//     all-reduces them over the group;
//   - psld_gn_split_apply runs the fused kernel's chain from the global
//     sums (mean and rstd from them, f32 or the gn_bf16 rounding points,
//     affine, act), one launch.
// Bound: the stats read x once and the apply reads it again and writes
// y, so two reads and one write, a few f32 operations an element.
//
// Both walk the same tiles: a block of 256 threads owns a run of pixel
// rows of one batch element (the grid is (tiles, batch), no division an
// element), and a thread owns one 16-byte piece of a row (8 bf16 or 4
// f32 channels; one channel, up to four of them, where C is no multiple
// of the piece: the scalar path) and the rows RY apart.
//
// The stats (ops/group_norm.py::plan_split_stats sizes a chunk: one wave
// of four blocks an SM over a large shard, one block a batch element of
// up to 128 KB) keep STATS_UNROLL loads in flight and add f32 sums of x
// and x^2 a channel. The rows a warp holds are folded with shuffles, the
// warps' in shared memory in slot order, then the channels into groups
// in channel order. A batch element of one chunk writes its sums; else
// each block writes a partial, and the last block of the batch element
// to finish (a __threadfence and a counter in done[n], left at 0) adds
// the chunks' partials in a fixed order: lane l of a group adds the
// chunks [l * K, (l + 1) * K) in order, the lanes by a fixed shuffle
// tree. The sums are deterministic and a call is one launch.
//
// The apply (ops/group_norm.py::plan_split_apply sizes a tile: two passes
// of APPLY_UNROLL rows a thread over a large shard, fewer rows where the
// batch's tiles would give under 264 blocks) computes its channels'
// constants once a thread: mean and rstd from their (n, group) sums with
// the plain version's formula (a piece spans two groups where a group
// has 4 channels, so they are a channel's), scale and bias, each rounded
// to bf16 once under gn_bf16. It keeps APPLY_UNROLL 16-byte loads in
// flight and runs the fused kernel's Affine on each piece (the f32 chain
// as one fma a channel, gn_bf16 in bf16 pairs), 16-byte stores.
//
// What holds them back (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's
// [spatial_kernels], the 105 split GroupNorms of a CelebA-HQ 256 rank
// forward at B=8, bf16 gn_bf16): the stats read 52% of their bytes
// bound, the apply 0.70 (PERF.md section 6). On the shards of 8,192 and
// 32,768 pixels the apply runs at ~0.9 of its bound; its 66 calls of 8
// to 512 pixels take ~3.5 us each, a launch and one chain of loads and
// stores, and the stats' small calls 3-7 us, where the fold's fence and
// counter add to the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SMEM = 232448;   // shared memory a block may have
constexpr int MAX_CLUSTER = 8;     // portable cluster size
constexpr int CHUNKS = 4;          // commit groups of a thread's staging

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of T as N floats, and back
template <typename T>
struct Vec;

template <>
struct Vec<float> {
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
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(psld::pack_bf16(f[0], f[1]), psld::pack_bf16(f[2], f[3]),
                      psld::pack_bf16(f[4], f[5]), psld::pack_bf16(f[6], f[7]));
  }
};

// 0 none, 1 swish, 2 relu, 3 elu, 4 leaky relu (0.2), in f32 as PyTorch's
// CUDA kernels compute them, except that swish takes the special-function
// unit's exponential and reciprocal (2 ulp): the exact ones would cost
// more instructions than the rest of the element's work, and an error of
// a few f32 ulp moves a bf16 rounding only rarely
template <int ACT>
__device__ __forceinline__ float act_of(float z) {
  if (ACT == 1) return __fdividef(z, 1.f + __expf(-z));
  if (ACT == 2) return z > 0.f ? z : 0.f;
  if (ACT == 3) return z > 0.f ? z : expm1f(z);
  if (ACT == 4) return z > 0.f ? z : z * 0.2f;
  return z;
}

__device__ __forceinline__ float load_param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// the gn_bf16 chain on a pair of channels in bf16 pair arithmetic, each
// operation rounded once as PyTorch's bf16 operations (computed in f32,
// rounded to bf16) are; then the activation in f32, rounded once
template <int ACT>
__device__ __forceinline__ uint32_t chain_pair(uint32_t x, uint32_t mu,
                                               uint32_t rs, uint32_t sc,
                                               uint32_t bi) {
  const uint32_t z = psld::add_bf16x2(
      psld::mul_bf16x2(psld::mul_bf16x2(psld::sub_bf16x2(x, mu), rs), sc),
      bi);
  if (ACT == 0) return z;
  const float2 f = psld::unpack_bf16(z);
  return psld::pack_bf16(act_of<ACT>(f.x), act_of<ACT>(f.y));
}

// normalize + affine + act of one 16-byte piece (NV channels of T) from
// the channels' f32 scale, bias, mean and rstd (bf16 values already under
// CHAIN): the f32 chain as one fma a channel, z = x * (rstd * scale) +
// (bias - mean * rstd * scale); the bf16 chain in bf16 pairs
template <typename T, bool CHAIN>
struct Affine {
  static constexpr int NV = Vec<T>::N;
  float ka[NV], kb[NV];
  uint32_t mu[NV / 2], rs[NV / 2], sc[NV / 2], bi[NV / 2];

  __device__ Affine(const float* scale, const float* bias, const float* mean,
                    const float* rstd) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      ka[v] = rstd[v] * scale[v];
      kb[v] = bias[v] - mean[v] * ka[v];
    }
#pragma unroll
    for (int p = 0; p < NV / 2; ++p) {
      // the conversions are exact under CHAIN
      sc[p] = psld::pack_bf16(scale[2 * p], scale[2 * p + 1]);
      bi[p] = psld::pack_bf16(bias[2 * p], bias[2 * p + 1]);
      mu[p] = psld::pack_bf16(mean[2 * p], mean[2 * p + 1]);
      rs[p] = psld::pack_bf16(rstd[2 * p], rstd[2 * p + 1]);
    }
  }

  template <int ACT>
  __device__ uint4 apply(const uint4& u) const {
    if constexpr (CHAIN) {
      return make_uint4(chain_pair<ACT>(u.x, mu[0], rs[0], sc[0], bi[0]),
                        chain_pair<ACT>(u.y, mu[1], rs[1], sc[1], bi[1]),
                        chain_pair<ACT>(u.z, mu[2], rs[2], sc[2], bi[2]),
                        chain_pair<ACT>(u.w, mu[3], rs[3], sc[3], bi[3]));
    } else {
      float f[NV], o[NV];
      Vec<T>::unpack(u, f);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        o[v] = act_of<ACT>(fmaf(f[v], ka[v], kb[v]));
      return Vec<T>::pack(o);
    }
  }
};

// wait until at most n (< CHUNKS) of this thread's commit groups are in
// flight
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: psld::cp_async_wait<0>(); break;
    case 1: psld::cp_async_wait<1>(); break;
    case 2: psld::cp_async_wait<2>(); break;
    default: psld::cp_async_wait<3>(); break;
  }
}

// bytes of shared memory for ``res`` resident rows of an S-channel slice
// in a block of nt threads: x, then f32 scratch (the host planner computes
// the same)
__host__ __device__ constexpr size_t smem_bytes(int res, int s, int elem,
                                                int nt) {
  return (size_t)res * s * elem +
         sizeof(float) * (2 * (size_t)(nt / 32) * s + 8 * (size_t)s);
}

// block (cluster q of item q = (batch element q / slices, slice q %
// slices), rank r): the r-th run of the item's pixel rows; NT threads
template <typename T, int ACT, bool CHAIN, int NT>
__global__ void __launch_bounds__(NT, 768 / NT)
gn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
              const void* __restrict__ scale, int scale_bf16,
              const void* __restrict__ bias, int bias_bf16, int hw, int c,
              int cgrp, int s, int res_rows, float eps) {
  using V = Vec<T>;
  constexpr int NV = V::N;    // channels of a 16-byte piece
  constexpr int NW = NT / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int slices = c / s, item = blockIdx.x / ncl;
  const int s0 = (item % slices) * s;
  const int per = (hw + ncl - 1) / ncl;
  const int p0 = min(hw, rank * per);
  const int rows = min(hw, p0 + per) - p0;
  const int res = min(rows, res_rows);
  // a row's pieces take cols lanes of cp, the next power of two: the rows
  // a warp holds side by side then share their lanes' channels
  const int cols = s / NV;
  int cp = 1;
  while (cp < cols) cp *= 2;
  const int R = NT / cp;
  const int tid = threadIdx.x, j = tid % cp, r = tid / cp, warp = tid / 32;
  const bool active = j < cols;
  const size_t base = ((size_t)(item / slices) * hw + p0) * c + s0 + j * NV;
  const T* xb = x + base;
  T* yb = y + base;

  extern __shared__ uint4 smem_u4[];
  T* xs = reinterpret_cast<T*>(smem_u4) + j * NV;
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<T*>(smem_u4) + (size_t)res_rows * s);  // [2][NW][s]
  float* blk = red + 2 * NW * s;  // [2][s]: this block's sums of x, x^2
  float* tot = blk + 2 * s;       // [2][s]: the cluster's totals
  float* prm = tot + 2 * s;       // [4][s]: scale, bias, mean, rstd

  // this thread's resident rows r, r + R, ... < res: ``mine`` of them,
  // staged in CHUNKS commit groups; then its rows past res, read from
  // device memory
  const int mine = active && r < res ? (res - r + R - 1) / R : 0;
  const int tail0 = r + mine * R;
#pragma unroll 1
  for (int k = 0; k < CHUNKS; ++k) {
    for (int i = k * mine / CHUNKS; i < (k + 1) * mine / CHUNKS; ++i) {
      const int row = r + i * R;
      psld::cp_async16(xs + (size_t)row * s, xb + (size_t)row * c, true);
    }
    psld::cp_async_commit();
  }
  // the slice's scale and bias (s <= 2 * NT), in flight with x
  float pr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tid + h * NT < s) {
      pr[2 * h] = load_param(scale, scale_bf16, s0 + tid + h * NT);
      pr[2 * h + 1] = load_param(bias, bias_bf16, s0 + tid + h * NT);
    }
  }

  // ---- moments: each commit group's sums as soon as it has landed
  float f[NV], a1[NV], a2[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) a1[v] = a2[v] = 0.f;
  auto add = [&](const uint4& u) {
    V::unpack(u, f);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a1[v] += f[v];
      a2[v] += f[v] * f[v];
    }
  };
#pragma unroll 1
  for (int k = 0; k < CHUNKS; ++k) {
    wait_groups(CHUNKS - 1 - k);
#pragma unroll 2
    for (int i = k * mine / CHUNKS; i < (k + 1) * mine / CHUNKS; ++i)
      add(*reinterpret_cast<const uint4*>(xs + (size_t)(r + i * R) * s));
  }
  if (active) {
#pragma unroll 2
    for (int row = tail0; row < rows; row += R)
      add(__ldg(reinterpret_cast<const uint4*>(xb + (size_t)row * c)));
  }
  // over the rows of a warp (lanes of one channel piece), a fixed tree
  for (int d = cp; d < 32; d *= 2) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a1[v] += __shfl_xor_sync(0xffffffffu, a1[v], d);
      a2[v] += __shfl_xor_sync(0xffffffffu, a2[v], d);
    }
  }
  if (tid % 32 < cp && active) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      red[warp * s + j * NV + v] = a1[v];
      red[(NW + warp) * s + j * NV + v] = a2[v];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tid + h * NT < s) {
      prm[tid + h * NT] = CHAIN ? bf16r(pr[2 * h]) : pr[2 * h];
      prm[s + tid + h * NT] = CHAIN ? bf16r(pr[2 * h + 1]) : pr[2 * h + 1];
    }
  }
  __syncthreads();
  // over the warps, in order; then over the blocks of a cluster, in rank
  // order (a block alone has its totals already)
  for (int i = tid; i < 2 * s; i += NT) {
    const float* col = red + (i / s) * NW * s + i % s;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) acc += col[w * s];
    (ncl > 1 ? blk : tot)[i] = acc;
  }
  if (ncl > 1) {
    cluster.sync();
    for (int i = tid; i < 2 * s; i += NT) {
      float acc = 0.f;
      for (int q = 0; q < ncl; ++q)
        acc += cluster.map_shared_rank(blk, q)[i];
      tot[i] = acc;
    }
  }
  __syncthreads();
  // into groups: every channel of a group adds the same terms in the same
  // order
  // 1 / n as PyTorch's mean takes it (a sum times its factor)
  const float inv_n = 1.f / ((float)hw * (float)cgrp);
  for (int i = tid; i < s; i += NT) {
    const int g0 = i / cgrp * cgrp;
    float m1 = 0.f, m2 = 0.f;
    for (int q = g0; q < g0 + cgrp; ++q) {
      m1 += tot[q];
      m2 += tot[s + q];
    }
    const float mean = m1 * inv_n;
    const float var =
        fmaxf(__fsub_rn(m2 * inv_n, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(var + eps);
    prm[2 * s + i] = CHAIN ? bf16r(mean) : mean;
    prm[3 * s + i] = CHAIN ? bf16r(rstd) : rstd;
  }
  __syncthreads();

  // ---- normalize + affine + act, 16-byte stores
  if (active) {
    const int ch = j * NV;
    const Affine<T, CHAIN> aff(prm + ch, prm + s + ch, prm + 2 * s + ch,
                               prm + 3 * s + ch);
#pragma unroll 2
    for (int i = 0; i < mine; ++i) {
      const size_t row = (size_t)(r + i * R);
      *reinterpret_cast<uint4*>(yb + row * c) = aff.template apply<ACT>(
          *reinterpret_cast<const uint4*>(xs + row * s));
    }
#pragma unroll 2
    for (int row = tail0; row < rows; row += R)
      *reinterpret_cast<uint4*>(yb + (size_t)row * c) =
          aff.template apply<ACT>(
              __ldg(reinterpret_cast<const uint4*>(xb + (size_t)row * c)));
  }
  // no block leaves while a peer may still read its blk
  if (ncl > 1) cluster.sync();
}

// Small maps: a warp owns a work item and holds its pieces in registers
// (at most WP of them a lane), so the chain of loads, sums and stores has
// no barrier and no shared memory; four work items a block. Groups fold
// within a lane (cgrp divides the NV channels of a piece) or over the
// lanes of a row (cgrp a power-of-two multiple of NV); the host planner
// takes this path only then.
constexpr int WP = 8;

template <typename T, int ACT, bool CHAIN>
__global__ void __launch_bounds__(128)
gn_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const void* __restrict__ scale, int scale_bf16,
                   const void* __restrict__ bias, int bias_bf16, int items,
                   int hw, int c, int cgrp, int s, float eps) {
  using V = Vec<T>;
  constexpr int NV = V::N;
  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * 4 + threadIdx.x / 32;
  if (item >= items) return;
  const int slices = c / s, s0 = (item % slices) * s;
  const int cols = s / NV;
  int cp = 1;
  while (cp < cols) cp *= 2;
  const int j = lane % cp, r = lane / cp, R = 32 / cp;
  const bool active = j < cols;
  const size_t base = (size_t)(item / slices) * hw * c + s0 + j * NV;

  // every piece in flight at once, then the sums
  uint4 u[WP];
#pragma unroll
  for (int p = 0; p < WP; ++p) {
    const int row = r + p * R;
    u[p] = active && row < hw
               ? __ldg(reinterpret_cast<const uint4*>(x + base +
                                                      (size_t)row * c))
               : make_uint4(0u, 0u, 0u, 0u);
  }
  float sc[NV], bi[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    sc[v] = active ? load_param(scale, scale_bf16, s0 + j * NV + v) : 0.f;
    bi[v] = active ? load_param(bias, bias_bf16, s0 + j * NV + v) : 0.f;
    if (CHAIN) {
      sc[v] = bf16r(sc[v]);
      bi[v] = bf16r(bi[v]);
    }
  }
  float f[NV], a1[NV], a2[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) a1[v] = a2[v] = 0.f;
#pragma unroll
  for (int p = 0; p < WP; ++p) {
    V::unpack(u[p], f);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a1[v] += f[v];
      a2[v] += f[v] * f[v];
    }
  }
  // over the rows (lanes of one channel piece), a fixed tree that leaves
  // the same totals in every lane
  for (int d = cp; d < 32; d *= 2) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a1[v] += __shfl_xor_sync(0xffffffffu, a1[v], d);
      a2[v] += __shfl_xor_sync(0xffffffffu, a2[v], d);
    }
  }
  // into groups, every channel of a group adding the same terms in the
  // same order: within the lane, then over the lanes of a group
  // (cgrp < NV is a power of two: a group is the channels v with the same
  // v & gmask)
  const int gmask = cgrp >= NV ? 0 : ~(cgrp - 1);
  float m1[NV], m2[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    m1[v] = m2[v] = 0.f;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if ((q & gmask) == (v & gmask)) {
        m1[v] += a1[q];
        m2[v] += a2[q];
      }
    }
  }
  for (int d = 1; d < cgrp / NV; d *= 2) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      m1[v] += __shfl_xor_sync(0xffffffffu, m1[v], d);
      m2[v] += __shfl_xor_sync(0xffffffffu, m2[v], d);
    }
  }
  // 1 / n as PyTorch's mean takes it (a sum times its factor)
  const float inv_n = 1.f / ((float)hw * (float)cgrp);
  float mu[NV], rs[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float mean = m1[v] * inv_n;
    const float var =
        fmaxf(__fsub_rn(m2[v] * inv_n, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(var + eps);
    mu[v] = CHAIN ? bf16r(mean) : mean;
    rs[v] = CHAIN ? bf16r(rstd) : rstd;
  }
  const Affine<T, CHAIN> aff(sc, bi, mu, rs);
#pragma unroll
  for (int p = 0; p < WP; ++p) {
    const int row = r + p * R;
    if (active && row < hw)
      *reinterpret_cast<uint4*>(y + base + (size_t)row * c) =
          aff.template apply<ACT>(u[p]);
  }
}

template <typename T, int ACT, bool CHAIN, int NT>
int launch_blocks(const void* x, void* y, const void* scale, int scale_bf16,
                  const void* bias, int bias_bf16, int b, int hw, int c,
                  int cgrp, int s, int cl, int res, float eps,
                  cudaStream_t stream) {
  auto kernel = gn_fwd_kernel<T, ACT, CHAIN, NT>;
  const size_t smem = smem_bytes(res, s, sizeof(T), NT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c / s) * b * cl, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // a cluster of one block launches as a plain grid, which schedules
  // sooner; the kernel then sees a cluster of one
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<T*>(y), scale, scale_bf16, bias,
                           bias_bf16, hw, c, cgrp, s, res, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int ACT, bool CHAIN, int NT>
int launch(const void* x, void* y, const void* scale, int scale_bf16,
           const void* bias, int bias_bf16, int b, int hw, int c, int cgrp,
           int s, int cl, int res, float eps, cudaStream_t stream) {
  if constexpr (NT == 32) {
    const int items = (c / s) * b;
    gn_fwd_warp_kernel<T, ACT, CHAIN><<<(items + 3) / 4, 128, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), scale, scale_bf16,
        bias, bias_bf16, items, hw, c, cgrp, s, eps);
    return (int)cudaGetLastError();
  } else {
    return launch_blocks<T, ACT, CHAIN, NT>(x, y, scale, scale_bf16, bias,
                                            bias_bf16, b, hw, c, cgrp, s, cl,
                                            res, eps, stream);
  }
}


template <typename T, bool CHAIN, int NT, typename... Args>
int dispatch(int act, Args... args) {
  switch (act) {
    case 0: return launch<T, 0, CHAIN, NT>(args...);
    case 1: return launch<T, 1, CHAIN, NT>(args...);
    case 2: return launch<T, 2, CHAIN, NT>(args...);
    case 3: return launch<T, 3, CHAIN, NT>(args...);
    case 4: return launch<T, 4, CHAIN, NT>(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// (B, H*W, C) NHWC x -> y of x's type. dtype: 0 = float32, 1 = bfloat16;
// scale_bf16 / bias_bf16: the parameters' type; chain: 1 = the gn_bf16
// chain (bfloat16 only). slice (channels, whole groups), cluster (blocks
// of one slice), resident (pixel rows a block stages) and threads (128 or
// 256, a block; 32: a warp a work item, its pieces in registers) come
// from the host planner. x and y lie on 16-byte
// boundaries. Returns a cudaError_t.
int psld_gn_fwd(const void* x, void* y, const void* scale, int scale_bf16,
                const void* bias, int bias_bf16, int b, int hw, int c,
                int cgrp, int slice, int cluster, int resident, int threads,
                int act, int chain, float eps, int dtype, void* stream) {
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || (chain && dtype != 1) ||
      (threads != 32 && threads != 128 && threads != 256) || b < 1 ||
      hw < 1 || cgrp < 1 ||
      slice < cgrp || slice % cgrp || c % slice ||
      (size_t)b * (c / slice) * cluster > 0x7fffffff ||
      (slice * elem) % 16 || slice * elem > 512 || slice > 2 * threads ||
      cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
      resident < 0 ||
      smem_bytes(resident, slice, elem, threads) > (size_t)MAX_SMEM ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  if (threads == 32) {
    // a warp a work item: its pieces fit the registers, its groups fold
    // within a lane or over a power of two of lanes, no cluster
    const int nv = 16 / elem, cols = slice / nv;
    int cp = 1;
    while (cp < cols) cp *= 2;
    const int k = cgrp / nv;
    if (cluster != 1 || (hw + 32 / cp - 1) / (32 / cp) > WP ||
        !(cgrp <= nv ? nv % cgrp == 0 : cgrp % nv == 0 && !(k & (k - 1))))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && threads == 32)
    return dispatch<float, false, 32>(act, x, y, scale, scale_bf16, bias,
                                      bias_bf16, b, hw, c, cgrp, slice,
                                      cluster, resident, eps, st);
  if (dtype == 0 && threads == 128)
    return dispatch<float, false, 128>(act, x, y, scale, scale_bf16, bias,
                                       bias_bf16, b, hw, c, cgrp, slice,
                                       cluster, resident, eps, st);
  if (dtype == 0)
    return dispatch<float, false, 256>(act, x, y, scale, scale_bf16, bias,
                                       bias_bf16, b, hw, c, cgrp, slice,
                                       cluster, resident, eps, st);
#define PSLD_BF16(CH, NT)                                                     \
  return dispatch<__nv_bfloat16, CH, NT>(act, x, y, scale, scale_bf16, bias, \
                                         bias_bf16, b, hw, c, cgrp, slice,   \
                                         cluster, resident, eps, st)
  if (chain && threads == 32) PSLD_BF16(true, 32);
  if (chain && threads == 128) PSLD_BF16(true, 128);
  if (chain) PSLD_BF16(true, 256);
  if (threads == 32) PSLD_BF16(false, 32);
  if (threads == 128) PSLD_BF16(false, 128);
  PSLD_BF16(false, 256);
#undef PSLD_BF16
}

const char* psld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

namespace {

constexpr int SPLIT_THREADS = 256;
// pixel rows a thread of the stats has in flight (2, 4 and 8 measured,
// PERF.md section 6)
constexpr int STATS_UNROLL = 8;
// floats of each of the stats' two channel-sum buffers: slots x C
constexpr int STATS_SLOTS = 2048;
// pixel rows a thread of the apply has in flight (2, 4 and 8 measured,
// PERF.md section 6; the planner, ops/group_norm.py::_APPLY_UNROLL, makes
// a tile of several a multiple of the pass, SPLIT_THREADS / pieces *
// APPLY_UNROLL rows, and the entry refuses a tile that is not)
constexpr int APPLY_UNROLL = 4;

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

// V channels of x at p as floats: one 16-byte load (V = Vec<T>::N), or
// one scalar (V = 1)
template <typename T, int V>
struct PieceLoad {
  using Raw = uint4;
  __device__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(const Raw& r, float* f) {
    Vec<T>::unpack(r, f);
  }
};

template <typename T>
struct PieceLoad<T, 1> {
  using Raw = float;
  __device__ static Raw load(const T* p) { return elem_f(*p); }
  __device__ static Raw zero() { return 0.f; }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = r; }
};

// block (chunk, n): the f32 sums of x and x^2 of each group over pixels
// [chunk * rows, +rows) of batch element n. A thread owns V channels of a
// row (KP pieces of them on the scalar path) and the rows RY apart,
// STATS_UNROLL of them in flight; the rows are folded by warp shuffles
// (where a warp holds several) and in shared memory, then the channels
// into groups. With one chunk a row the block writes out[n]; else it
// writes part[n][chunk], and the last block of batch element n to finish
// (counted in done[n], which it leaves at 0) adds the chunks' partials
// in a fixed order into out[n].
template <typename T, int V>
__global__ void __launch_bounds__(SPLIT_THREADS)
gn_split_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                      float* __restrict__ out, int* __restrict__ done,
                      int hw, int c, int cgrp, int rows) {
  using L = PieceLoad<T, V>;
  constexpr int KP = V == 1 ? 1024 / SPLIT_THREADS : 1;
  constexpr int U = STATS_UNROLL;
  __shared__ float sh1[STATS_SLOTS], sh2[STATS_SLOTS];
  __shared__ int last;
  const int n = blockIdx.y, chunk = blockIdx.x, nch = gridDim.x;
  const int tid = threadIdx.x;
  const int pieces = c / V;
  const int tx_n = pieces < SPLIT_THREADS ? pieces : SPLIT_THREADS;
  const int ry = SPLIT_THREADS / tx_n;
  const int tx = tid % tx_n, ty = tid / tx_n;
  const int p0 = chunk * rows;
  const int p1 = min(hw, p0 + rows);
  const T* xb = x + (size_t)n * hw * c;
  float s1[KP][V], s2[KP][V];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) s1[k][v] = s2[k][v] = 0.f;
  if (ty < ry) {
    for (int p = p0 + ty; p < p1; p += ry * U) {
      typename L::Raw raw[U][KP];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int row = p + u * ry, pc = tx + k * tx_n;
          raw[u][k] = row < p1 && pc < pieces
                          ? L::load(xb + (size_t)row * c + (size_t)pc * V)
                          : L::zero();
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          float f[V];
          L::unpack(raw[u][k], f);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s1[k][v] += f[v];
            s2[k][v] = fmaf(f[v], f[v], s2[k][v]);
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
        s1[0][v] += __shfl_xor_sync(0xffffffffu, s1[0][v], off);
        s2[0][v] += __shfl_xor_sync(0xffffffffu, s2[0][v], off);
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
          sh1[slot * c + pc * V + v] = s1[k][v];
          sh2[slot * c + pc * V + v] = s2[k][v];
        }
    }
  }
  __syncthreads();
  // slots -> channels, in slot order, into slot 0
  for (int ch = tid; ch < c; ch += SPLIT_THREADS) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < slots; ++r) {
      a += sh1[r * c + ch];
      b += sh2[r * c + ch];
    }
    sh1[ch] = a;
    sh2[ch] = b;
  }
  __syncthreads();
  // channels -> groups, in channel order
  const int ng = c / cgrp;
  for (int g = tid; g < ng; g += SPLIT_THREADS) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cgrp; ++j) {
      a += sh1[g * cgrp + j];
      b += sh2[g * cgrp + j];
    }
    float* o = nch == 1 ? out + ((size_t)n * ng + g) * 2
                        : part + (((size_t)n * nch + chunk) * ng + g) * 2;
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  }
  if (nch == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + n, 1) == nch - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: lane l of a group's LN lanes adds the chunks [l * K,
  // (l + 1) * K) in chunk order, 8 loads in flight; the lanes are then
  // added by a fixed shuffle tree
  int ln = 1;
  while (ln < 32 && 2 * ln * ng <= SPLIT_THREADS) ln *= 2;
  const int per = (nch + ln - 1) / ln;
  for (int g0 = 0; g0 < ng; g0 += SPLIT_THREADS / ln) {
    const int g = g0 + tid / ln, l = tid % ln;
    float a = 0.f, b = 0.f;
    if (g < ng) {
      const int k1 = min(nch, (l + 1) * per);
      const float2* src =
          reinterpret_cast<const float2*>(part) + (size_t)n * nch * ng + g;
      for (int k0 = l * per; k0 < k1; k0 += 8) {
        float2 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = k0 + j < k1 ? __ldcg(src + (size_t)(k0 + j) * ng)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          a += v[j].x;
          b += v[j].y;
        }
      }
    }
    for (int off = ln / 2; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (g < ng && l == 0)
      *reinterpret_cast<float2*>(out + ((size_t)n * ng + g) * 2) =
          make_float2(a, b);
  }
  if (tid == 0) done[n] = 0;
}

template <typename T, int V>
void split_stats(const void* x, float* part, float* out, int* done, int b,
                 int hw, int c, int cgrp, int rows, int nch,
                 cudaStream_t st) {
  gn_split_stats_kernel<T, V><<<dim3(nch, b), SPLIT_THREADS, 0, st>>>(
      static_cast<const T*>(x), part, out, done, hw, c, cgrp, rows);
}

// block (tile, n): y of pixels [tile * rows, +rows) of batch element n
// from the global sums. A thread owns V channels of a row (KP pieces of
// them on the scalar path) and the rows RY apart, APPLY_UNROLL of them in
// flight; it computes its channels' constants once (mean and rstd from
// their (n, group) sums, scale and bias, rounded to bf16 under CHAIN), and
// runs the fused kernel's Affine on 16-byte pieces (the scalar path the
// same chain a channel at a time).
template <typename T, int V, int ACT, bool CHAIN>
__global__ void __launch_bounds__(SPLIT_THREADS)
gn_split_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const float* __restrict__ sums,
                      const void* __restrict__ scale, int scale_bf16,
                      const void* __restrict__ bias, int bias_bf16, int hw,
                      int c, int cgrp, int rows, float inv_n, float eps) {
  using L = PieceLoad<T, V>;
  constexpr int KP = V == 1 ? 1024 / SPLIT_THREADS : 1;
  constexpr int U = APPLY_UNROLL;
  const int n = blockIdx.y, tid = threadIdx.x;
  const int pieces = c / V;
  const int tx_n = pieces < SPLIT_THREADS ? pieces : SPLIT_THREADS;
  const int ry = SPLIT_THREADS / tx_n;
  const int tx = tid % tx_n, ty = tid / tx_n;
  if (ty >= ry) return;
  const int p0 = blockIdx.x * rows;
  const int p1 = p0 + min(hw - p0, rows);
  const size_t base = (size_t)n * hw * c;
  const T* xb = x + base;
  T* yb = y + base;
  typename L::Raw raw[U][KP];
  auto load_rows = [&](int r) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int row = r + u * ry, pc = tx + k * tx_n;
        raw[u][k] = row < p1 && pc < pieces
                        ? L::load(xb + (size_t)row * c + (size_t)pc * V)
                        : L::zero();
      }
  };
  // the first rows go out before the constants' loads
  load_rows(p0 + ty);
  float mu[KP][V], rs[KP][V], sc[KP][V], bi[KP][V];
  const float* sn = sums + (size_t)n * (c / cgrp) * 2;
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int ch = min((tx + k * tx_n) * V + v, c - 1);
      const float* sm = sn + (ch / cgrp) * 2;
      const float mean = sm[0] * inv_n;
      const float var =
          fmaxf(__fsub_rn(__fmul_rn(sm[1], inv_n), __fmul_rn(mean, mean)),
                0.f);
      const float rstd = rsqrtf(var + eps);
      const float s = load_param(scale, scale_bf16, ch);
      const float b = load_param(bias, bias_bf16, ch);
      mu[k][v] = CHAIN ? bf16r(mean) : mean;
      rs[k][v] = CHAIN ? bf16r(rstd) : rstd;
      sc[k][v] = CHAIN ? bf16r(s) : s;
      bi[k][v] = CHAIN ? bf16r(b) : b;
    }
  if constexpr (V > 1) {
    const Affine<T, CHAIN> aff(sc[0], bi[0], mu[0], rs[0]);
    for (int r = p0 + ty; r < p1; r += ry * U) {
      if (r != p0 + ty) load_rows(r);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = r + u * ry;
        if (row < p1)
          *reinterpret_cast<uint4*>(yb + (size_t)row * c + (size_t)tx * V) =
              aff.template apply<ACT>(raw[u][0]);
      }
    }
  } else {
    // the fused kernel's f32 chain as one fma a channel
    float ka[KP], kb[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      ka[k] = rs[k][0] * sc[k][0];
      kb[k] = bi[k][0] - mu[k][0] * ka[k];
    }
    for (int r = p0 + ty; r < p1; r += ry * U) {
      if (r != p0 + ty) load_rows(r);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int row = r + u * ry, pc = tx + k * tx_n;
          if (row >= p1 || pc >= pieces) continue;
          const float v = raw[u][k];
          const float z =
              CHAIN ? bf16r(bf16r(bf16r(bf16r(v - mu[k][0]) * rs[k][0]) *
                                  sc[k][0]) + bi[k][0])
                    : fmaf(v, ka[k], kb[k]);
          yb[(size_t)row * c + pc] = to_elem<T>(act_of<ACT>(z));
        }
    }
  }
}

template <typename T, int V, bool CHAIN>
int split_apply(int act, const void* x, void* y, const float* sums,
                const void* scale, int sbf, const void* bias, int bbf, int b,
                int hw, int c, int cgrp, int rows, float inv_n, float eps,
                cudaStream_t st) {
  const dim3 grid((unsigned)(((long long)hw + rows - 1) / rows), b);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define PSLD_APPLY(A)                                                       \
  gn_split_apply_kernel<T, V, A, CHAIN><<<grid, SPLIT_THREADS, 0, st>>>(   \
      xt, yt, sums, scale, sbf, bias, bbf, hw, c, cgrp, rows, inv_n, eps); \
  break
  switch (act) {
    case 0: PSLD_APPLY(0);
    case 1: PSLD_APPLY(1);
    case 2: PSLD_APPLY(2);
    case 3: PSLD_APPLY(3);
    case 4: PSLD_APPLY(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PSLD_APPLY
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (B, H*W, C) NHWC x (this rank's rows) -> out (B, C / cgrp, 2) f32: each
// group's sums of x and x^2 over the local pixels, one launch. rows:
// pixels a block reduces (ops/group_norm.py::plan_split_stats); vec: the
// channels a load, 16 / sizeof(T) (C a multiple of it) or 1. With more
// than one chunk a batch element, part holds B * ceil(H*W / rows) *
// (C / cgrp) * 2 floats of scratch and done B ints at 0, which the
// launch leaves at 0. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t.
int psld_gn_split_stats(const void* x, void* part, void* out, void* done,
                        int b, int hw, int c, int cgrp, int rows, int vec,
                        int dtype, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || b < 1 || b > 65535 || hw < 1 ||
      c < 1 || c > 1024 || cgrp < 1 || c % cgrp || rows < 1 ||
      (vec != 1 && vec != wide) || c % vec)
    return (int)cudaErrorInvalidValue;
  const int nch = (int)(((long long)hw + rows - 1) / rows);
  if (nch > 1 && (part == nullptr || done == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  int* dn = static_cast<int*>(done);
  if (dtype == 0 && vec == 1)
    split_stats<float, 1>(x, pt, o, dn, b, hw, c, cgrp, rows, nch, st);
  else if (dtype == 0)
    split_stats<float, 4>(x, pt, o, dn, b, hw, c, cgrp, rows, nch, st);
  else if (vec == 1)
    split_stats<__nv_bfloat16, 1>(x, pt, o, dn, b, hw, c, cgrp, rows, nch,
                                  st);
  else
    split_stats<__nv_bfloat16, 8>(x, pt, o, dn, b, hw, c, cgrp, rows, nch,
                                  st);
  return (int)cudaGetLastError();
}

// (B, H*W, C) NHWC x -> y of x's type, normalized with the global sums
// (B, C / cgrp, 2) f32 over n elements a group (all ranks' pixels times
// cgrp). rows: pixels a block normalizes (ops/group_norm.py::
// plan_split_apply), with more than one tile a multiple of the pass
// (SPLIT_THREADS / (C / vec, at most SPLIT_THREADS) * APPLY_UNROLL rows);
// vec: the channels an access, 16 / sizeof(T) (C a multiple of it, x and
// y on 16-byte boundaries) or 1. scale_bf16 / bias_bf16: the parameters'
// type; chain: 1 = the gn_bf16 chain (bfloat16 only). Returns a
// cudaError_t.
int psld_gn_split_apply(const void* x, void* y, const void* sums,
                        const void* scale, int scale_bf16, const void* bias,
                        int bias_bf16, int b, int hw, int c, int cgrp,
                        float n, int act, int chain, float eps, int rows,
                        int vec, int dtype, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || (chain && dtype != 1) || b < 1 ||
      b > 65535 || hw < 1 || c < 1 || c > 1024 || cgrp < 1 || c % cgrp ||
      !(n > 0.f) || rows < 1 || (vec != 1 && vec != wide) || c % vec ||
      (vec != 1 && (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(y)) % 16))
    return (int)cudaErrorInvalidValue;
  const int pieces = c / vec;
  const int pass = SPLIT_THREADS / (pieces < SPLIT_THREADS ? pieces
                                                          : SPLIT_THREADS)
                   * APPLY_UNROLL;
  if (rows < hw && rows % pass) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sm = static_cast<const float*>(sums);
  const float inv_n = 1.f / n;
#define PSLD_SPLIT(T, V, CH)                                                 \
  return split_apply<T, V, CH>(act, x, y, sm, scale, scale_bf16, bias,       \
                               bias_bf16, b, hw, c, cgrp, rows, inv_n, eps,  \
                               st)
  if (dtype == 0 && vec == 1) PSLD_SPLIT(float, 1, false);
  if (dtype == 0) PSLD_SPLIT(float, 4, false);
  if (chain && vec == 1) PSLD_SPLIT(__nv_bfloat16, 1, true);
  if (chain) PSLD_SPLIT(__nv_bfloat16, 8, true);
  if (vec == 1) PSLD_SPLIT(__nv_bfloat16, 1, false);
  PSLD_SPLIT(__nv_bfloat16, 8, false);
#undef PSLD_SPLIT
}

}  // extern "C"
