// The bodies of the port's softmax attention core: one (image, head)
// pair, a range of its query rows, run by one block.
//
//   * `attention_tiles_mma` (bf16 operands, output bf16 or fp32): each warp
//     takes 16-row tiles on the tensor cores (attention_mma.cuh);
//   * `attention_rows` (fp32): kAttnWarps warps, one query row a warp at a
//     time, on the CUDA cores (fp32 stays there: TF32 would not hold the
//     fp32 tolerance).
//
// Shared by attention.cu (kernels B3, B7-B9 and the cores of B1 and B6)
// and block.cu (kernel B10, whose persistent blocks walk (image, head,
// row tile) units). Each .cu file compiles in its own nvcc process, so the
// bodies live here as inline device functions. The design notes are in
// attention.cu.
#pragma once

#include <math.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "common.cuh"

namespace fern {

constexpr int kMaxSeq = 256;
constexpr int kAttnWarps = 8;

// K row stride in elements: an odd number of 32-bit words
template <typename T, int D> struct KStride;
template <int D> struct KStride<float, D> { static constexpr int value = D + 1; };

__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T, int D>
__host__ __device__ constexpr size_t attention_smem_bytes(int sk) {
  return align16((size_t)sk * KStride<T, D>::value * sizeof(T)) +
         align16((size_t)sk * D * sizeof(T)) +
         (size_t)kAttnWarps * (D + kMaxSeq) * sizeof(float);
}

// fp32: rows [row0, row1) of head h of image b. smem: attention_smem_bytes(Sk)
// bytes, 16-byte aligned. With `causal` (Sq == Sk) only the keys up to
// row1 are staged: later keys carry the -1e30 bias for every row here.
// Ends with a block barrier, so the caller may restage at once.
// kBias: the bias is a template flag, so the kernels without one (B1,
// B3, B6, B7, B8, B10) compile to the same code as before it existed.
template <typename T, typename TO, int D, bool kBias>
__device__ __forceinline__ void attention_rows(unsigned char* smem, const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               const float* __restrict__ bias,
                                               TO* __restrict__ out, int b, int h, int row0,
                                               int row1, int Sq, int Sk, int H, int q_ld,
                                               int kv_ld, int causal, float scale) {
  static_assert(D % 2 == 0 && D <= 128, "head dim: even, at most 128");
  constexpr int kPairs = D / 2;
  constexpr int kPairRounds = (kPairs + 31) / 32;
  constexpr int kld = KStride<T, D>::value;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16((size_t)Sk * kld * sizeof(T)));
  float* qbuf = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Vs) +
                                         align16((size_t)Sk * D * sizeof(T)));
  float* pbuf = qbuf + kAttnWarps * D;

  const int W = H * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)b * Sq * q_ld + h * D;
  const T* kb = k + (size_t)b * Sk * kv_ld + h * D;
  const T* vb = v + (size_t)b * Sk * kv_ld + h * D;

  const int staged = causal ? min(row1, Sk) : Sk;
  for (int idx = threadIdx.x; idx < staged * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    Ks[j * kld + d] = kb[(size_t)j * kv_ld + d];
    Vs[j * D + d] = vb[(size_t)j * kv_ld + d];
  }
  __syncthreads();

  float* qw = qbuf + warp * D;
  float* pw = pbuf + warp * kMaxSeq;
  for (int i = row0 + warp; i < row1; i += kAttnWarps) {
    const T* qrow = qb + (size_t)i * q_ld;
    for (int d = lane; d < D; d += 32) qw[d] = to_f(qrow[d]);
    __syncwarp();
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qw[d];

    const int jmax = causal ? i + 1 : Sk;  // keys past i carry the -1e30 bias: p = 0
    const float* brow = kBias ? bias + (size_t)i * Sk : nullptr;
    float s[kMaxSeq / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < jmax) {
        const T* kr = Ks + j * kld;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 2) {
          const float2 kv = load2(kr + d);
          dot = fmaf(qr[d], kv.x, dot);
          dot = fmaf(qr[d + 1], kv.y, dot);
        }
        // the bias is added to the rounded product, as the plain version
        // does (no fused multiply-add)
        if constexpr (kBias)
          s[t] = __fadd_rn(__fmul_rn(dot, scale), brow[j]);
        else
          s[t] = dot * scale;
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float denom = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < jmax ? expf(s[t] - m) : 0.f;
      denom += s[t];
    }
    denom = warp_sum(denom);
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < jmax) pw[j] = round_to<T>(s[t] / denom);
    }
    __syncwarp();

    TO* orow = out + ((size_t)b * Sq + i) * W + h * D;
#pragma unroll
    for (int r = 0; r < kPairRounds; ++r) {
      const int d = 2 * (lane + 32 * r);
      if (d < D) {
        float o0 = 0.f, o1 = 0.f;
        for (int j = 0; j < jmax; ++j) {
          const float p = pw[j];
          const float2 vv = load2(Vs + j * D + d);
          o0 = fmaf(p, vv.x, o0);
          o1 = fmaf(p, vv.y, o1);
        }
        orow[d] = from_f<TO>(o0);
        orow[d + 1] = from_f<TO>(o1);
      }
    }
    __syncwarp();  // qw / pw are rewritten by the next row
  }
  __syncthreads();  // Ks / Vs are read before anyone restages them
}

// Keys are staged and scored in pairs of 16-key tiles: one branch a pair,
// so the two tiles' products interleave.
constexpr int kKeyPair = 2 * kKeyTile;

// Shared bytes of `attention_tiles_mma` at Sk keys for `warps` warps: K
// and V of the head (Sk rounded up to 32 keys) and 16 query rows a warp,
// rows of mma_lds(D) elements.
template <int D>
__host__ __device__ constexpr size_t attention_mma_smem_bytes(int sk, int warps) {
  return ((size_t)2 * ((sk + kKeyPair - 1) / kKeyPair * kKeyPair) + (size_t)warps * kMmaRows) *
         mma_lds(D) * sizeof(bf16);
}

// bf16: query rows of head h of image b in 16-row warp tiles starting at
// rows first, first + step, first + 2 step, ... below row_end (warp w
// takes the tiles w, w + warps, ...). K and V of the head are staged once
// (with `causal`, Sq == Sk, only the keys up to the block's last row:
// later keys carry the -1e30 bias for every row here), K and the first
// query tiles in one group of copies and V in a second, so that V lands
// while the first tiles are scored; each warp stages its tile's query
// rows. `width`: the staging width (attention_mma.cuh `staging_width` of
// q, k, v, their strides and D). NP: the most 32-key pairs of tiles a row
// reads (its scores stay in registers: 16 NP a lane). With kFixed and not
// `causal`, Sk needs exactly NP pairs and every tile scores all of them
// with no branch between them, so the compiler interleaves the pairs'
// products and softmax; otherwise (B10, causal rows) each tile scores the
// pairs its rows need. Ends with a block barrier, so the caller may
// restage at once.
//
// Rounding, as `attention_rows` and the Pallas kernels: fp32 scores from
// the bf16 products; times the scale, then + the bias, each rounded on
// its own; the row max; p = exp(s - m); the denominator; p / denom in
// fp32, rounded to bf16; P . V accumulated in fp32 and rounded once to
// the output type. A row's result depends on its own q row only, and a
// pair past the row's keys adds exactly nothing (its p are 0, its V rows
// zero), so every NP, kFixed and tiling of the rows gives the same bits
// (B10 and B1 + B2 run this body and agree bit for bit).
template <typename TO, int D, bool kBias, int NP, bool kFixed>
__device__ __forceinline__ void attention_tiles_mma(
    unsigned char* smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias, TO* __restrict__ out, int b,
    int h, int first, int step, int row_end, int Sq, int Sk, int H, int q_ld, int kv_ld,
    int causal, float scale, int width) {
  static_assert(D % 16 == 0 && NP * kKeyPair <= kMaxSeq, "head dim: a multiple of 16");
  constexpr int KT = 2 * NP;
  constexpr int lds = mma_lds(D);
  const int skp = (Sk + kKeyPair - 1) / kKeyPair * kKeyPair;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + skp * lds;
  bf16* Qw = Vs + skp * lds + warp * kMmaRows * lds;

  const int W = H * D;
  const bf16* qb = q + (size_t)b * Sq * q_ld + h * D;
  const bf16* kb = k + (size_t)b * Sk * kv_ld + h * D;
  const bf16* vb = v + (size_t)b * Sk * kv_ld + h * D;
  const int g = lane / 4, t = lane % 4;

  // the warp's query rows r0 .. r0 + 15 (zero past row_end)
  auto stage_q = [&](int r0) {
    stage_tile<D>(Qw, qb + (size_t)r0 * q_ld, q_ld, min(kMmaRows, row_end - r0), kMmaRows, D,
                  width, lane, 32);
  };
  float s[KT][8];  // scores, then exp(s - m)
  float l0, l1;    // the denominators of this lane's rows
  // scores and softmax numerators of the tile at row r0 (query rows
  // staged); `guard`: std::true_type to score only the pairs its rows need
  auto score = [&](int r0, auto guard) {
    constexpr bool kGuard = decltype(guard)::value;
    unsigned qf[D / 16][4];
    load_q_frags<D>(qf, Qw, lane);
    const int tile_end = min(r0 + kMmaRows, row_end);
    const int npairs = ((causal ? min(tile_end, Sk) : Sk) + kKeyPair - 1) / kKeyPair;
    const int i0 = r0 + g, i1 = r0 + g + 8;  // this lane's rows
    // keys past a row carry the -1e30 bias under `causal`: p = 0
    const int jm0 = causal ? i0 + 1 : Sk, jm1 = causal ? i1 + 1 : Sk;
    const int jfull = causal ? min(r0 + 1, Sk) : Sk;  // keys every row of the tile reads
    const float* brow0 = kBias && i0 < Sq ? bias + (size_t)i0 * Sk : nullptr;
    const float* brow1 = kBias && i1 < Sq ? bias + (size_t)i1 * Sk : nullptr;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; kt += 2) {
      if (!kGuard || kt / 2 < npairs) {
        qk_tile<D>(s[kt], qf, Ks + kt * kKeyTile * lds, lane);
        qk_tile<D>(s[kt + 1], qf, Ks + (kt + 1) * kKeyTile * lds, lane);
        // every pair before the last is inside Sk when the count is fixed
        const bool full = (!kGuard && kt / 2 < NP - 1) || (kt + 2) * kKeyTile <= jfull;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int kk = kt + u / 8, c = u % 8;
          const int j = kk * kKeyTile + (c / 4) * 8 + 2 * t + c % 2;
          const bool hi = (c / 2) % 2;
          const float x = full || j < (hi ? jm1 : jm0)
                              ? scaled_score<kBias>(s[kk][c], scale, hi ? brow1 : brow0, j)
                              : -INFINITY;
          s[kk][c] = x;
          if (hi)
            m1 = fmaxf(m1, x);
          else
            m0 = fmaxf(m0, x);
        }
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    l0 = l1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; kt += 2) {
      if (!kGuard || kt / 2 < npairs) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int kk = kt + u / 8, c = u % 8;
          const bool hi = (c / 2) % 2;
          s[kk][c] = expf(s[kk][c] - (hi ? m1 : m0));
          if (hi)
            l1 += s[kk][c];
          else
            l0 += s[kk][c];
        }
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  };
  // p / denom rounded to bf16, P . V, and the tile's output rows
  auto finish = [&](int r0, auto guard) {
    constexpr bool kGuard = decltype(guard)::value;
    const int tile_end = min(r0 + kMmaRows, row_end);
    const int npairs = ((causal ? min(tile_end, Sk) : Sk) + kKeyPair - 1) / kKeyPair;
    const double rl0 = 1.0 / l0, rl1 = 1.0 / l1;
    float o[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; kt += 2) {
      if (!kGuard || kt / 2 < npairs) {
#pragma unroll
        for (int kk = kt; kk < kt + 2; ++kk) {
          unsigned pa[4];
          probs_bf16(pa, s[kk], rl0, rl1);
          pv_tile<D>(o, pa, Vs + kk * kKeyTile * lds, lane);
        }
      }
    }
    const int i0 = r0 + g, i1 = r0 + g + 8;
    TO* o0 = out + ((size_t)b * Sq + i0) * W + h * D + 2 * t;
    TO* o1 = o0 + (size_t)8 * W;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      if (i0 < tile_end) store_pair(o0 + nd * 8, o[nd][0], o[nd][1]);
      if (i1 < tile_end) store_pair(o1 + nd * 8, o[nd][2], o[nd][3]);
    }
  };

  const int tiles = (row_end - first + step - 1) / step;
  const int last = min(row_end, first + (tiles - 1) * step + kMmaRows);
  const int staged = causal ? min(last, Sk) : Sk;
  const int staged_pad = (staged + kKeyPair - 1) / kKeyPair * kKeyPair;
  int r0 = first + warp * step;
  const bool has_tile = r0 < row_end;
  stage_tile<D>(Ks, kb, kv_ld, staged, staged_pad, D, width, threadIdx.x, blockDim.x);
  if (has_tile) stage_q(r0);
  cp_async_commit();
  stage_tile<D>(Vs, vb, kv_ld, staged, staged_pad, D, width, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait_one();  // K and the query rows
  __syncthreads();
  const bool fixed = kFixed && !causal;
  if (has_tile) {
    if (fixed)
      score(r0, std::false_type{});
    else
      score(r0, std::true_type{});
  }
  cp_async_wait_all();  // V
  __syncthreads();
  if (has_tile) {
    if (fixed)
      finish(r0, std::false_type{});
    else
      finish(r0, std::true_type{});
  }
  // later tiles of this warp (B10's units of more than warps tiles)
  for (r0 += warps * step; r0 < row_end; r0 += warps * step) {
    __syncwarp();
    stage_q(r0);
    cp_async_wait_all();
    __syncwarp();
    score(r0, std::true_type{});
    finish(r0, std::true_type{});
  }
  __syncthreads();  // Ks / Vs are read before anyone restages them
}

}  // namespace fern
