// GroupNorm + activation, backward, for Hopper (sm_90a).
//
// Replaces the custom VJP psld_tpu/ops/group_norm.py::_gn_bwd of the
// TPU kernel _gn_kernel (no kernel in the JAX package: a pull-back through
// the jnp chain). With xh = (x - mean) * rstd, z = xh * scale + bias,
// y = act(z) and the cotangent g of y:
//   dz = g * act'(z), dbias = sum dz, dscale = sum dz * xh,
//   dx = rstd * (dz * scale - mean_g(dz * scale) - xh * mean_g(dz * scale * xh))
// in f32, with the moments recomputed from x (single pass, variance
// clamped at 0, rsqrt(var + eps)); a group whose variance was clamped
// gets no gradient through the variance. Activation slopes at the kink
// follow PyTorch's, as autograd through the port's plain version takes
// them: relu 0 and leaky relu 0.2 at z = 0 (jax.nn's leaky relu takes 1
// there; under gn_bf16, where z is a bf16 value, some 2e-4 of the
// elements of a normal input land exactly on 0), elu exp(z) for z <= 0.
//
// Under gn_bf16 with bf16 x (CHAIN) it is the gradient of the forward's
// bf16 chain, as psld_tpu's _gn_bwd pulls back through
// group_norm_act_reference: with mb, rb, sb, bb the bf16 roundings of
// mean, rstd, scale and bias, d = bf16(x - mb), xh = bf16(d * rb), z =
// bf16(bf16(xh * sb) + bb), and act'(z) of that z. The cotangents are
// rounded to bf16 where autograd through the port's plain chain rounds
// them: dz = bf16(g * act'(z)), each term bf16(dz * xh) of dscale, dxh =
// bf16(dz * sb), dd = bf16(dxh * rb), the group sums -sum(dd) (of mb) and
// sum(dxh * d) (of rb), dscale and dbias, the f32 pull-back through the
// moments, A + B * x with A = (-sum(dd) - 2 mean dvar) / n, B = 2 dvar /
// n, dvar = -rstd^3 sum(dxh * d) / 2, and dx = bf16(dd + bf16(A + B * x)).
// Kept in f32: the two group sums themselves, taken as rb * sum(dz * sb)
// and sum(dz * xh * sb) / rb from the per-channel sums the f32 chain
// already has (each term of the plain version's sums is rounded to bf16
// first; its error, 2^-9 of a term, is not carried), and the slopes, from
// the special-function unit's exponential as in the f32 chain. The chain
// runs in bf16 pair arithmetic (one rounding of each exact result, as
// PyTorch's f32-then-round gives); ptxas (sm_90a, nvcc 12.8) gives its
// instantiations 80 registers, as the f32 chain's, no spills: the same
// three blocks of 256 threads an SM and the same plan.
//
// What bounds it on the H100: device-memory bytes. Per element it is ~30
// f32 operations against one read of x, one of g and one write of dx; at
// (128, 32, 32, 256) bf16 that is 201 MB, 60 us at 3.35 TB/s.
//
// Design: every byte of x and g is read from device memory once, dx is
// written once. A block of 128 or 256 threads (a cluster of 1 to 8 such
// blocks where one block's shared memory cannot hold the pixels) owns one
// batch element's slice of S channels, whole groups, S * sizeof(T) at
// most 128 contiguous bytes of an NHWC row; the host planner picks S, the
// cluster and the threads from (H*W, C, G, dtype). The block stages its x
// and g with cp.async in shared memory, x first, so the moments start
// while g is in flight, then runs three passes from shared memory: the
// channel sums of x and x^2, the channel sums of dz and dz * xh, and dx,
// written with 8- or 16-byte stores. The blocks of a cluster exchange
// their per-channel sums through distributed shared memory and add them
// in rank order, so every block holds the same totals. A cluster's
// barriers cost more than a narrower slice, so the planner takes a
// cluster only where a slice of whole groups cannot fit one block (H*W
// = 1024 at C = 384 in bf16; f32 at C = 512). Where a run of pixels is
// longer than shared memory holds (H*W of 16,384 and more at some
// widths), the rows past the resident ones are read from device memory
// in each pass.
//
// dscale and dbias: each cluster writes its (channel, batch element)
// partials into a (2, C, B) f32 buffer; the last cluster of a slice to
// finish, which an integer count tells it (no float atomics), adds the
// slice's B partials in a fixed order with independent 16-byte loads and
// writes dscale and dbias in the parameters' types, then resets the
// count for the next launch. The sum over the batch costs no launch of
// its own.
//
// What holds it back (H100, chip_smoke.py's rows): at H*W = 1024 it
// reaches about half its bytes bound. The passes cost some 45
// instructions an element (the swish derivative, with two special-function
// operations, is computed in pass 2 and again in pass 3) and a chain of
// barriers; a block stages, computes, then writes, and only the three
// blocks of an SM overlap those phases. A block alone skips the
// cluster's barriers, which cost more than its own.
//
// The split entry points of spatial parallelism (psld_gn_split_partials,
// psld_gn_split_dx) are in csrc/group_norm_split_bwd.cu, a library of
// their own, built beside this one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "group_norm_bwd.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SMEM = 232448;   // shared memory a block may have
constexpr int MAX_CLUSTER = 8;     // portable cluster size

// four channels of T as floats: 16 bytes of f32, 8 of bf16
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  using Word = uint4;
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
struct Piece<__nv_bfloat16> {
  using Word = uint2;
  __device__ static void unpack(const uint2& u, float* f) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ static uint2 pack(const float* f) {
    return make_uint2(psld::pack_bf16(f[0], f[1]), psld::pack_bf16(f[2], f[3]));
  }
};

// the bf16 chain of a pair of channels in bf16 pair arithmetic, each
// operation rounded once as PyTorch's bf16 operations are: xh =
// bf16(bf16(x - mb) * rb), z = bf16(bf16(xh * sb) + bb), dz = bf16(g *
// act'(z))
template <int ACT>
__device__ __forceinline__ void chain_pair(uint32_t x, uint32_t g,
                                           uint32_t mu, uint32_t rs,
                                           uint32_t sc, uint32_t bi,
                                           uint32_t& xh, uint32_t& dz) {
  xh = psld::mul_bf16x2(psld::sub_bf16x2(x, mu), rs);
  const float2 z =
      psld::unpack_bf16(psld::add_bf16x2(psld::mul_bf16x2(xh, sc), bi));
  const float2 gf = psld::unpack_bf16(g);
  dz = psld::pack_bf16(dz_of<ACT>(gf.x, z.x), dz_of<ACT>(gf.y, z.y));
}

// bytes of shared memory for ``res`` resident rows of an S-channel slice
// in a block of nt threads: x and g, then the f32 scratch (the host
// planner computes the same)
__host__ __device__ constexpr size_t smem_bytes(int res, int s, int elem,
                                                int nt) {
  return 2 * (size_t)res * s * elem +
         sizeof(float) * (2 * (size_t)(nt / (s / 4)) * s + 11 * s);
}

// block (cluster q of slice q / batch b = blockIdx.y, rank r): the r-th
// run of the pixels of batch element b's slice; NT threads
template <typename T, int ACT, bool CHAIN, int NT>
__global__ void __launch_bounds__(NT, 768 / NT)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              T* __restrict__ dx, const void* __restrict__ scale,
              int scale_bf16, const void* __restrict__ bias, int bias_bf16,
              float* __restrict__ part, int* __restrict__ done,
              void* __restrict__ dscale, void* __restrict__ dbias, int hw,
              int c, int cgrp, int s, int res_rows, float eps,
              int need_params) {
  constexpr int V = 4;                    // channels a thread computes
  constexpr int CV = 16 / sizeof(T);      // channels a 16-byte copy moves
  using Word = typename Piece<T>::Word;
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, nb = gridDim.y;
  const int s0 = (blockIdx.x / ncl) * s;
  const int per = (hw + ncl - 1) / ncl;
  const int p0 = min(hw, rank * per);
  const int rows = min(hw, p0 + per) - p0;
  const int res = min(rows, res_rows);
  const int cols = s / V, R = NT / cols;
  const int tid = threadIdx.x, j = tid % cols, r = tid / cols;
  const bool active = r < R;
  const size_t base = ((size_t)b * hw + p0) * c + s0;
  const T* xb = x + base;
  const T* gb = g + base;
  T* db = dx + base;

  extern __shared__ uint4 smem_u4[];
  T* xs = reinterpret_cast<T*>(smem_u4);
  T* gs = xs + (size_t)res_rows * s;
  float* red = reinterpret_cast<float*>(gs + (size_t)res_rows * s);
  float* xch1 = red + 2 * R * s;   // [2][s]: this block's sums of x, x^2
  float* xch2 = xch1 + 2 * s;      // [2][s]: of dz, dz * xh
  float* tot = xch2 + 2 * s;       // [2][s]: the cluster's totals
  float* prm = tot + 2 * s;        // [5][s]: scale, bias, mean, rstd,
                                   // live (1: variance not clamped)

  // stage x, then g, each its own commit group: the moments start while
  // g is still in flight
  const int ccols = s / CV;
  for (int src = 0; src < 2; ++src) {
    T* dst = src ? gs : xs;
    const T* from = src ? gb : xb;
    for (int i = tid; i < res * ccols; i += NT) {
      const int row = i / ccols, jj = i % ccols;
      psld::cp_async16(dst + (size_t)row * s + jj * CV,
                       from + (size_t)row * c + jj * CV, true);
    }
    psld::cp_async_commit();
  }
  for (int i = tid; i < s; i += NT) {
    const float sc = load_param(scale, scale_bf16, s0 + i);
    const float bi = load_param(bias, bias_bf16, s0 + i);
    prm[i] = CHAIN ? bf16r(sc) : sc;
    prm[s + i] = CHAIN ? bf16r(bi) : bi;
  }

  // row ``row``'s piece of a tensor: a resident row from shared memory,
  // the others (only where a run outgrows shared memory) from device
  // memory
  auto word = [&](const T* sm, const T* gm, int row, auto resident) {
    if constexpr (decltype(resident)::value)
      return *reinterpret_cast<const Word*>(sm + (size_t)row * s + j * V);
    else
      return __ldg(
          reinterpret_cast<const Word*>(gm + (size_t)row * c + j * V));
  };
  auto piece = [&](const T* sm, const T* gm, int row, float* f,
                   auto resident) {
    Piece<T>::unpack(word(sm, gm, row, resident), f);
  };
  // body(row, resident) over this thread's rows: the resident ones, then
  // the rest, each loop free of the other's test
  const int tail0 = r < res ? r + (res - r + R - 1) / R * R : r;
  auto walk = [&](auto&& body) {
    if (!active) return;
#pragma unroll 4
    for (int row = r; row < res; row += R) body(row, std::true_type{});
    for (int row = tail0; row < rows; row += R) body(row, std::false_type{});
  };
  // the block's per-channel sums of a[], bb[] (V channels a thread) into
  // out[0][s], out[1][s]: L lanes of a warp per sum, a fixed tree
  auto block_sums = [&](const float* a, const float* bb, float* out) {
    if (active) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red[r * s + j * V + v] = a[v];
        red[(R + r) * s + j * V + v] = bb[v];
      }
    }
    __syncthreads();
    const int O = 2 * s;
    int L = 1;
    while (L < 32 && 2 * L * O <= NT) L *= 2;
    for (int o0 = 0; o0 < O; o0 += NT / L) {
      const int o = o0 + tid / L, l = tid % L;
      float acc = 0.f;
      if (o < O) {
        const float* col = red + (o / s) * R * s + o % s;
        for (int rr = l; rr < R; rr += L) acc += col[rr * s];
      }
      for (int d = L / 2; d >= 1; d /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, d);
      if (o < O && l == 0) out[o] = acc;
    }
  };
  // the cluster's totals of out[2][s], added in rank order, into tot; a
  // block alone skips the cluster's barrier, which costs more
  auto cluster_sums = [&](float* mine) {
    if (ncl > 1)
      cluster.sync();
    else
      __syncthreads();
    for (int i = tid; i < 2 * s; i += NT) {
      float acc = 0.f;
      for (int q = 0; q < ncl; ++q)
        acc += ncl > 1 ? cluster.map_shared_rank(mine, q)[i] : mine[i];
      tot[i] = acc;
    }
    __syncthreads();
  };

  const float n = (float)hw * (float)cgrp;
  float f[V], h[V], a1[V], a2[V];

  // ---- pass 1: moments
  psld::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int v = 0; v < V; ++v) a1[v] = a2[v] = 0.f;
  walk([&](int row, auto resident) {
    piece(xs, xb, row, f, resident);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a1[v] += f[v];
      a2[v] += f[v] * f[v];
    }
  });
  block_sums(a1, a2, xch1);
  cluster_sums(xch1);
  // fold the channels of each group; every channel of a group adds the
  // same terms in the same order
  for (int i = tid; i < s; i += NT) {
    const int g0 = i / cgrp * cgrp;
    float m1 = 0.f, m2 = 0.f;
    for (int q = g0; q < g0 + cgrp; ++q) {
      m1 += tot[q];
      m2 += tot[s + q];
    }
    // the moments as the forward kernel takes them (a sum times 1 / n,
    // as PyTorch's mean), so the bf16 chain rounds the same mean and rstd
    const float inv_n = 1.f / n;
    const float mean = CHAIN ? m1 * inv_n : m1 / n;
    const float raw =
        CHAIN ? __fsub_rn(m2 * inv_n, __fmul_rn(mean, mean))
              : m2 / n - mean * mean;
    prm[2 * s + i] = mean;
    // the bf16 chain's rstd as the forward and the plain version take it
    prm[3 * s + i] = CHAIN ? rsqrtf(fmaxf(raw, 0.f) + eps)
                           : 1.f / sqrtf(fmaxf(raw, 0.f) + eps);
    prm[4 * s + i] = raw >= 0.f ? 1.f : 0.f;
  }
  psld::cp_async_wait<0>();
  __syncthreads();

  float sc[V], bi[V], mu[V], rs[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int ch = j * V + v;
    sc[v] = prm[ch]; bi[v] = prm[s + ch];
    mu[v] = prm[2 * s + ch]; rs[v] = prm[3 * s + ch];
    if (CHAIN) {
      mu[v] = bf16r(mu[v]);
      rs[v] = bf16r(rs[v]);
    }
    a1[v] = a2[v] = 0.f;
  }
  // the bf16 chain's operands as pairs (bf16 values already: the
  // conversions are exact)
  uint32_t mu2[2], rs2[2], sc2[2], bi2[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    mu2[p] = psld::pack_bf16(mu[2 * p], mu[2 * p + 1]);
    rs2[p] = psld::pack_bf16(rs[2 * p], rs[2 * p + 1]);
    sc2[p] = psld::pack_bf16(sc[2 * p], sc[2 * p + 1]);
    bi2[p] = psld::pack_bf16(bi[2 * p], bi[2 * p + 1]);
  }

  // ---- pass 2: sums of dz and dz * xh (under CHAIN, of bf16(dz * xh))
  walk([&](int row, auto resident) {
    if constexpr (CHAIN) {
      const Word xw = word(xs, xb, row, resident);
      const Word gw = word(gs, gb, row, resident);
      const uint32_t xp[2] = {xw.x, xw.y}, gp[2] = {gw.x, gw.y};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t xh, dz;
        chain_pair<ACT>(xp[p], gp[p], mu2[p], rs2[p], sc2[p], bi2[p], xh,
                        dz);
        const float2 d = psld::unpack_bf16(dz);
        const float2 e = psld::unpack_bf16(psld::mul_bf16x2(dz, xh));
        a1[2 * p] += d.x; a1[2 * p + 1] += d.y;
        a2[2 * p] += e.x; a2[2 * p + 1] += e.y;
      }
    } else {
      piece(xs, xb, row, f, resident);
      piece(gs, gb, row, h, resident);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (f[v] - mu[v]) * rs[v];
        const float dz = dz_of<ACT>(h[v], xh * sc[v] + bi[v]);
        a1[v] += dz;
        a2[v] += dz * xh;
      }
    }
  });
  block_sums(a1, a2, xch2);  // red is free: cluster_sums synchronised
  cluster_sums(xch2);
  // tot[0] = dbias, tot[1] = dscale of (b, slice); partials (2, C, B):
  // dscale, then dbias, a channel's batch contiguous. The last cluster of
  // a slice to finish (an integer count, which it resets) adds the
  // slice's partials over the batch in a fixed order and writes dscale
  // and dbias, after its pass 3. One thread fences and counts while the
  // others go on to pass 3.
  const bool counts = need_params && rank == 0;
  if (counts) {
    for (int i = tid; i < s; i += NT) {
      part[(size_t)(s0 + i) * nb + b] = tot[s + i];
      part[((size_t)c + s0 + i) * nb + b] = tot[i];
    }
  }
  // group means of dz * scale and dz * scale * xh, on the channels, into
  // xch1 (no peer reads it past the last barrier); under CHAIN the
  // pull-back's A and B
  for (int i = tid; i < s; i += NT) {
    const int g0 = i / cgrp * cgrp;
    float m1 = 0.f, m2 = 0.f;
    for (int q = g0; q < g0 + cgrp; ++q) {
      m1 += tot[q] * prm[q];
      m2 += tot[s + q] * prm[q];
    }
    if (CHAIN) {
      const float mean = prm[2 * s + i], rstd = prm[3 * s + i];
      const float rb = bf16r(rstd);
      const float sum_dd = bf16r(rb * m1), sum_dxh_d = bf16r(m2 / rb);
      const float dvar =
          -0.5f * sum_dxh_d * rstd * rstd * rstd * prm[4 * s + i];
      xch1[i] = (-sum_dd - 2.f * mean * dvar) / n;
      xch1[s + i] = 2.f * dvar / n;
    } else {
      xch1[i] = m1 / n;
      xch1[s + i] = m2 / n * prm[4 * s + i];
    }
  }
  __syncthreads();  // also orders the partials before the fence below
  int* last = reinterpret_cast<int*>(red);  // free after block_sums
  if (counts && tid == 0) {
    __threadfence();
    *last = atomicAdd(done + s0 / s, 1) == nb - 1;
  }
  float m1c[V], m2c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m1c[v] = xch1[j * V + v];
    m2c[v] = xch1[s + j * V + v];
  }

  // ---- pass 3: dx
  walk([&](int row, auto resident) {
    Word out;
    if constexpr (CHAIN) {
      // dx = bf16(dd + bf16(A + B * x)), dd = bf16(bf16(dz * sb) * rb)
      const Word xw = word(xs, xb, row, resident);
      const Word gw = word(gs, gb, row, resident);
      const uint32_t xp[2] = {xw.x, xw.y}, gp[2] = {gw.x, gw.y};
      uint32_t o[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t xh, dz;
        chain_pair<ACT>(xp[p], gp[p], mu2[p], rs2[p], sc2[p], bi2[p], xh,
                        dz);
        const uint32_t dd =
            psld::mul_bf16x2(psld::mul_bf16x2(dz, sc2[p]), rs2[p]);
        const float2 xf = psld::unpack_bf16(xp[p]);
        o[p] = psld::add_bf16x2(
            dd, psld::pack_bf16(fmaf(m2c[2 * p], xf.x, m1c[2 * p]),
                                fmaf(m2c[2 * p + 1], xf.y, m1c[2 * p + 1])));
      }
      out.x = o[0];
      out.y = o[1];
    } else {
      piece(xs, xb, row, f, resident);
      piece(gs, gb, row, h, resident);
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (f[v] - mu[v]) * rs[v];
        const float dz = dz_of<ACT>(h[v], xh * sc[v] + bi[v]);
        o[v] = rs[v] * (dz * sc[v] - m1c[v] - xh * m2c[v]);
      }
      out = Piece<T>::pack(o);
    }
    *reinterpret_cast<Word*>(db + (size_t)row * c + j * V) = out;
  });
  if (counts) {
    __syncthreads();
    if (*last) {
      __threadfence();
      const int O = 2 * s;
      int L = 1;
      while (L < 32 && 2 * L * O <= NT) L *= 2;
      for (int o0 = 0; o0 < O; o0 += NT / L) {
        const int o = o0 + tid / L, l = tid % L;
        float acc = 0.f;
        if (o < O) {
          // row (o / s, s0 + o % s) of the partials: 16-byte loads, 8
          // of them in flight a thread, added in a fixed order
          const float* row = part + ((size_t)(o / s) * c + s0 + o % s) * nb;
          float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (nb % 4 == 0) {
            const float4* r4 = reinterpret_cast<const float4*>(row);
            for (int q0 = l; q0 < nb / 4; q0 += 8 * L) {
              float4 v[8];
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                const int q = q0 + k * L;
                v[k] = q < nb / 4 ? __ldcg(r4 + q)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
              }
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                a4.x += v[k].x; a4.y += v[k].y;
                a4.z += v[k].z; a4.w += v[k].w;
              }
            }
          } else {
            for (int q = l; q < nb; q += L) a4.x += __ldcg(row + q);
          }
          acc = (a4.x + a4.y) + (a4.z + a4.w);
        }
        for (int d = L / 2; d >= 1; d /= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, d);
        if (o < O && l == 0) {
          const int ch = s0 + o % s;
          void* out = o < s ? dscale : dbias;
          if (o < s ? scale_bf16 : bias_bf16)
            static_cast<__nv_bfloat16*>(out)[ch] = __float2bfloat16_rn(acc);
          else  // under CHAIN autograd rounds the sum to bf16 first
            static_cast<float*>(out)[ch] = CHAIN ? bf16r(acc) : acc;
        }
      }
      if (tid == 0) done[s0 / s] = 0;
    }
  }
  // no block leaves while a peer may still read its xch2
  if (ncl > 1) cluster.sync();
}

template <typename T, int ACT, bool CHAIN, int NT>
int launch(const void* x, const void* g, void* dx, const void* scale,
           int scale_bf16, const void* bias, int bias_bf16, float* part,
           int* done, void* dscale, void* dbias, int b, int hw, int c,
           int cgrp, int s, int cl, int res, float eps, int need_params,
           cudaStream_t stream) {
  auto kernel = gn_bwd_kernel<T, ACT, CHAIN, NT>;
  const size_t smem = smem_bytes(res, s, sizeof(T), NT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c / s) * cl, b, 1);
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
                           static_cast<const T*>(g), static_cast<T*>(dx),
                           scale, scale_bf16, bias, bias_bf16, part, done,
                           dscale, dbias, hw, c, cgrp, s, res, eps,
                           need_params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// (B, H*W, C) NHWC x and cotangent g -> dx, and, if need_params, dscale
// and dbias (C,) in the parameters' types, summed over the batch through
// the (2, C, B) f32 partials buffer ``part`` and the per-slice counts
// ``done`` (C / slice ints, 0 before a launch and after it).
// dtype: 0 = float32, 1 = bfloat16 (x, g, dx); scale_bf16 / bias_bf16:
// the parameters' type; chain: 1 = the gradient of the gn_bf16 chain
// (bfloat16 only). slice (channels, whole groups), cluster (blocks of one
// slice), resident (pixel rows a block stages) and threads (128 or 256, a
// block) come from the host planner. Returns a cudaError_t.
int psld_gn_bwd(const void* x, const void* g, void* dx, const void* scale,
                int scale_bf16, const void* bias, int bias_bf16, void* part,
                void* done, void* dscale, void* dbias, int b, int hw, int c,
                int cgrp, int slice, int cluster, int resident, int threads,
                int act, int chain, float eps, int need_params, int dtype,
                void* stream) {
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || (chain && dtype != 1) ||
      (threads != 128 && threads != 256) ||
      b < 1 || b > 65535 || hw < 1 || cgrp < 1 || slice < cgrp ||
      slice % cgrp || c % slice || (slice * elem) % 16 ||
      slice > 4 * threads || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) || resident < 0 ||
      smem_bytes(resident, slice, elem, threads) > (size_t)MAX_SMEM ||
      (need_params && (!part || !done || !dscale || !dbias)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  int* dn = static_cast<int*>(done);
#define PSLD_LAUNCH(T, CH, NT)                                              \
  return dispatch<T, CH, NT>(act, x, g, dx, scale, scale_bf16, bias,        \
                             bias_bf16, pt, dn, dscale, dbias, b, hw, c,    \
                             cgrp, slice, cluster, resident, eps,           \
                             need_params, st)
  if (dtype == 0 && threads == 128) PSLD_LAUNCH(float, false, 128);
  if (dtype == 0) PSLD_LAUNCH(float, false, 256);
  if (chain && threads == 128) PSLD_LAUNCH(__nv_bfloat16, true, 128);
  if (chain) PSLD_LAUNCH(__nv_bfloat16, true, 256);
  if (threads == 128) PSLD_LAUNCH(__nv_bfloat16, false, 128);
  PSLD_LAUNCH(__nv_bfloat16, false, 256);
#undef PSLD_LAUNCH
}

const char* psld_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
