// The bodies of the port's softmax attention core: one (image, head)
// pair, a range of its query rows, run by one block, each warp taking
// 16-row tiles on the tensor cores:
//
//   * `attention_tiles_mma` (bf16 operands, output bf16 or fp32): bf16
//     `mma.sync` tiles (attention_mma.cuh);
//   * `attention_tiles_tf32` (fp32): 3xTF32 `mma.sync` tiles with fp32
//     accuracy (attention_tf32.cuh).
//
// Shared by attention.cu (kernels B3, B7-B9 and the cores of B1 and B6,
// through attention_bf16.cuh and attention_fp32.cuh) and block.cu (kernel
// B10, whose persistent blocks walk (image, head, row tile) units). Each
// .cu file compiles in its own nvcc process, so the bodies live here as
// inline device functions. The design notes are in attention.cu.
#pragma once

#include <math.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "common.cuh"

namespace fern {

constexpr int kMaxSeq = 256;

// Keys are counted by the fp32 instances in groups of four 8-key tiles
// (32 keys, as the bf16 instances count pairs of 16-key tiles).
constexpr int kTfKeyGroup = 4 * kTfKeyTile;

// Shared bytes of `attention_tiles_tf32` at Sk keys for `warps` warps: K
// and V of the head (Sk rounded up to 32 keys), rows of tf32_qk_lds(D) and
// tf32_v_lds(D) words, and 16 query rows a warp.
template <int D>
__host__ __device__ constexpr size_t attention_tf32_smem_bytes(int sk, int warps) {
  return ((size_t)((sk + kTfKeyGroup - 1) / kTfKeyGroup * kTfKeyGroup) *
              (tf32_qk_lds(D) + tf32_v_lds(D)) +
          (size_t)warps * kMmaRows * tf32_qk_lds(D)) *
         sizeof(float);
}

// fp32: query rows of head h of image b in 16-row warp tiles starting at
// rows first, first + step, first + 2 step, ... below row_end (warp w takes
// the tiles w, w + warps, ...), as `attention_tiles_mma` below. K and V of
// the head are staged once (with `causal`, Sq == Sk, only the keys up to
// the block's last row), K and the first query tiles in one group of
// `cp.async` copies and V in a second, so that V lands while the first
// tiles are scored. `width`: the staging width (attention_mma.cuh
// `staging_width` of 4-byte elements). NP: the most 32-key groups a row
// reads (its scores stay in registers: 4 NP a lane). With kFixed and not
// `causal`, Sk needs exactly NP groups: the 8-key tiles of the first NP - 1
// are scored with no branch between them (the last group's tiles past Sk
// are skipped); otherwise (B10, causal rows) each tile scores the groups
// its rows need.
//
// S = Q K^T runs k-step by k-step over all the tiles' keys, so a lane
// holds one k-step's split query fragment at a time (8 registers, not
// D); then the softmax in fp32 on the CUDA cores, at the rounding points
// of the plain version: fp32 scores; times the scale, then + the bias,
// each rounded on its own; the row max; p = exp(s - m); the denominator,
// summed over the keys in order; p / denom as the IEEE fp32 quotient;
// P . V in 3xTF32 with a fold a key tile, the output in fp32. A row's
// result depends on its own q row only, and a group past the row's keys
// adds exactly nothing (p = 0, V rows zero past Sk), so every NP, kFixed
// and tiling of the rows gives the same bits (B10 and B1 + B2 run this
// body and agree bit for bit). Ends with a block barrier, so the caller
// may restage at once.
template <int D, bool kBias, int NP, bool kFixed>
__device__ __forceinline__ void attention_tiles_tf32(
    unsigned char* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias, float* __restrict__ out, int b,
    int h, int first, int step, int row_end, int Sq, int Sk, int H, int q_ld, int kv_ld,
    int causal, float scale, int width) {
  static_assert(D % 8 == 0 && NP * kTfKeyGroup <= kMaxSeq, "head dim: a multiple of 8");
  constexpr int KT = 4 * NP;  // 8-key tiles
  constexpr int qld = tf32_qk_lds(D), vld = tf32_v_lds(D);
  const int skp = (Sk + kTfKeyGroup - 1) / kTfKeyGroup * kTfKeyGroup;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + skp * qld;
  float* Qw = Vs + skp * vld + warp * kMmaRows * qld;

  const int W = H * D;
  const float* qb = q + (size_t)b * Sq * q_ld + h * D;
  const float* kb = k + (size_t)b * Sk * kv_ld + h * D;
  const float* vb = v + (size_t)b * Sk * kv_ld + h * D;
  const int g = lane / 4, t = lane % 4;

  // the warp's query rows r0 .. r0 + 15 (zero past row_end)
  auto stage_q = [&](int r0) {
    stage_rows_f32<D, tf32_qk_lds(D)>(Qw, qb + (size_t)r0 * q_ld, q_ld, min(kMmaRows, row_end - r0),
                           kMmaRows, D, width, lane, 32);
  };
  // the keys the rows of the tile at r0 read
  auto tile_keys = [&](int r0) { return causal ? min(min(r0 + kMmaRows, row_end), Sk) : Sk; };
  float s[KT][4];  // scores, then the probabilities
  // the probabilities p = exp(s - m) / l of the tile at row r0 (query rows
  // staged); `guard`: std::true_type to score only the groups its rows need
  auto score = [&](int r0, auto guard) {
    constexpr bool kGuard = decltype(guard)::value;
    const int keys = tile_keys(r0);
    const int ngroups = (keys + kTfKeyGroup - 1) / kTfKeyGroup;
    const int ntiles = (keys + kTfKeyTile - 1) / kTfKeyTile;
    const int i0 = r0 + g, i1 = r0 + g + 8;  // this lane's rows
    // keys past a row carry the -1e30 bias under `causal`: p = 0
    const int jm0 = causal ? i0 + 1 : Sk, jm1 = causal ? i1 + 1 : Sk;
    const int jfull = causal ? min(r0 + 1, Sk) : Sk;  // keys every row of the tile reads
    const float* brow0 = kBias && i0 < Sq ? bias + (size_t)i0 * Sk : nullptr;
    const float* brow1 = kBias && i1 < Sq ? bias + (size_t)i1 * Sk : nullptr;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) s[kt][0] = s[kt][1] = s[kt][2] = s[kt][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      load_q_tf32<tf32_qk_lds(D)>(ah, al, Qw, kk, lane);
#pragma unroll
      for (int grp = 0; grp < NP; ++grp) {
        if (!kGuard || grp < ngroups) {
#pragma unroll
          for (int kt = 4 * grp; kt < 4 * grp + 4; ++kt)
            if (kGuard || kt < KT - 4 || kt < ntiles)
              qk_step_tf32<tf32_qk_lds(D)>(s[kt], ah, al, Ks + kt * kTfKeyTile * qld, kk,
                                                  lane);
        }
      }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kGuard ? kt / 4 < ngroups : kt < KT - 4 || kt < ntiles) {
        // every group before the last is inside Sk when the count is fixed
        const bool full = (!kGuard && kt < KT - 4) || (kt + 1) * kTfKeyTile <= jfull;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = kt * kTfKeyTile + 2 * t + c % 2;
          const bool hi = c / 2;
          const float x = full || j < (hi ? jm1 : jm0)
                              ? scaled_score<kBias>(s[kt][c], scale, hi ? brow1 : brow0, j)
                              : -INFINITY;
          s[kt][c] = x;
          if (hi)
            m1 = fmaxf(m1, x);
          else
            m0 = fmaxf(m0, x);
        }
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;  // the denominators of this lane's rows
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kGuard ? kt / 4 < ngroups : kt < KT - 4 || kt < ntiles) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool hi = c / 2;
          s[kt][c] = expf(s[kt][c] - (hi ? m1 : m0));
          if (hi)
            l1 += s[kt][c];
          else
            l0 += s[kt][c];
        }
      }
    }
    // p / denom in place: the IEEE fp32 quotient, from one reciprocal a row
    const double rl0 = 1.0 / quad_sum(l0), rl1 = 1.0 / quad_sum(l1);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kGuard ? kt / 4 < ngroups : kt < KT - 4 || kt < ntiles) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[kt][c] = div_rn(s[kt][c], c / 2 ? rl1 : rl0);
      }
    }
  };
  // P . V and the tile's output rows
  auto finish = [&](int r0, auto guard) {
    constexpr bool kGuard = decltype(guard)::value;
    const int keys = tile_keys(r0);
    const int ngroups = (keys + kTfKeyGroup - 1) / kTfKeyGroup;
    const int ntiles = (keys + kTfKeyTile - 1) / kTfKeyTile;
    float o[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kGuard ? kt / 4 < ngroups : kt < KT - 4 || kt < ntiles)
        pv_tile_tf32<vld, D / 8>(o, s[kt], Vs + kt * kTfKeyTile * vld, lane);
    }
    const int tile_end = min(r0 + kMmaRows, row_end);
    const int i0 = r0 + g, i1 = r0 + g + 8;
    float* o0 = out + ((size_t)b * Sq + i0) * W + h * D + 2 * t;
    float* o1 = o0 + (size_t)8 * W;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      if (i0 < tile_end) store_pair(o0 + nd * 8, o[nd][0], o[nd][1]);
      if (i1 < tile_end) store_pair(o1 + nd * 8, o[nd][2], o[nd][3]);
    }
  };

  const int tiles = (row_end - first + step - 1) / step;
  const int last = min(row_end, first + (tiles - 1) * step + kMmaRows);
  const int staged = causal ? min(last, Sk) : Sk;
  const int staged_pad = (staged + kTfKeyGroup - 1) / kTfKeyGroup * kTfKeyGroup;
  int r0 = first + warp * step;
  const bool has_tile = r0 < row_end;
  stage_rows_f32<D, qld>(Ks, kb, kv_ld, staged, staged_pad, D, width, threadIdx.x, blockDim.x);
  if (has_tile) stage_q(r0);
  cp_async_commit();
  stage_rows_f32<D, vld>(Vs, vb, kv_ld, staged, staged_pad, D, width, threadIdx.x, blockDim.x);
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
// Rounding, as `attention_tiles_tf32` and the Pallas kernels: fp32 scores from
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
