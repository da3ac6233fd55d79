// fp32 tensor-core tiles of the port's attention kernels: a warp holds 16
// query rows and runs 3xTF32 `mma.sync.m16n8k8` (tf32 operands, fp32
// accumulators) over 8-key tiles staged in shared memory, to fp32
// accuracy. The fp32 counterpart of attention_mma.cuh's bf16 tiles.
//
// Shared by the attention core (attention_core.cuh `attention_tiles_tf32`:
// kernels B1, B3, B7-B10 and X2-X4 in fp32) and the grouped kernel
// (attention_grouped.cu: X1 and B9's long keys in fp32).
//
//   * 3xTF32: each operand x is split as hi = tf32(x) (`cvt.rna`
//     rounding, common.cuh `tf32_rna`) and lo = tf32(x - hi), and a
//     product is lo.hi + hi.lo + hi.hi, small terms first (the dropped
//     lo.lo is ~2^-22 of it). One tf32 pass keeps about three decimal
//     digits, too few for the fp32 tolerance (2e-5).
//   * Folds: the tensor cores do not round their fp32 accumulation to
//     nearest (each mma truncates), so the three mmas of a k-step (S) or
//     of a key tile (P . V) go into a fresh partial that the CUDA cores
//     add to the sum, rounding to nearest. With a truncating accumulator
//     emulated on the CPU, one accumulator over X1's 256 keys at D = 128
//     (std-2 operands) drifts past the 2e-5 tolerance from the float64
//     result, and with the folds it stays under 1e-5 (tests/test_torch_ops.py
//     test_attention_tf32_folds_hold_against_truncating_accumulation).
//   * Operands are split at fragment load (five integer and float
//     operations a value): staged K and V stay raw fp32, since hi and lo
//     words would double their shared memory (256 keys of K and V at
//     D = 80 are 176 KB raw). Splitting the grouped kernel's chunks once a
//     block gained little in exploratory probes, and its hi and lo words
//     leave no room for two blocks an SM.
//   * S = Q K^T over D / 8 k-steps. The mma's k index t is head dim 2t of
//     the step and t + 4 is dim 2t + 1 (the sum over the dims does not
//     care which is which), so a lane's two A values of a row (a0, a2) and
//     its two B values of a key (b0, b1) are adjacent words, one 8-byte
//     shared load each. Q and K rows are D + 8 words apart (8 mod 16): the
//     16 lanes of one 8-byte load phase, rows g = 0..3 at words 2t and
//     2t + 1, hit 32 different banks.
//   * P . V with P straight from the S accumulators. The accumulator of an
//     8-key tile holds keys 2t, 2t + 1 of rows g and g + 8 (c0, c1; c2,
//     c3), but the A operand of m16n8k8 holds keys t and t + 4. P . V sums
//     over the keys, so the key order is permuted instead: k' = t is key
//     2t and k' = t + 4 is key 2t + 1. Then A = (c0, c2, c1, c3), and V's B
//     operand (b0 at k' = t, b1 at k' = t + 4, column g) is read from the
//     staged rows 2t and 2t + 1: an address change, no shuffle. V rows are
//     D + 4 words apart (4 mod 16): rows 2t land 8t banks apart, and the 8
//     columns g fill each group of 8, so one load hits 32 banks.
//   * Row statistics as in the bf16 tiles: each lane holds rows g and g + 8,
//     and a row's max and sum are reduced over its quad.
#pragma once

#include "attention_mma.cuh"

namespace fern {

constexpr int kTfKeyTile = 8;  // keys of one mma tile (N of S, K of P . V)

// Shared row strides of staged fp32 rows, in words: Q and K, and V.
__host__ __device__ constexpr int tf32_qk_lds(int d) { return d + 8; }
__host__ __device__ constexpr int tf32_v_lds(int d) { return d + 4; }

// Rows [0, rows_pad) x columns [0, DP) of a shared fp32 tile at row stride
// LDS words: rows [0, rows) and columns [0, cols) from `src` at row stride
// `ld`, zeros elsewhere. Thread `tid` of `nthreads` takes every
// nthreads-th copy; `width` is the launcher's staging width
// (`staging_width` with 4-byte elements: 16, else 4; 16 needs cols % 4 ==
// 0). The copies are asynchronous: the caller commits and waits.
template <int DP, int LDS>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* __restrict__ src, int ld,
                                               int rows, int rows_pad, int cols, int width,
                                               int tid, int nthreads) {
  if (width == 16) {
    constexpr int kUnits = DP / 4;
    for (int u = tid; u < rows_pad * kUnits; u += nthreads) {
      const int r = u / kUnits, c = (u % kUnits) * 4;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * LDS + c, in ? src + (size_t)r * ld + c : src, in);
    }
  } else {
    for (int u = tid; u < rows_pad * DP; u += nthreads) {
      const int r = u / DP, c = u % DP;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * LDS + c, in ? src + (size_t)r * ld + c : src, in);
    }
  }
}

// d += a . b for one m16n8k8 tile: tf32 operands (fp32 words whose low 13
// bits are zero), fp32 accumulators. Not volatile: a pure function of its
// operands, which the compiler may interleave with others.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_lo(x, hi);
}

// d += a . b in 3xTF32 (a, b split into hi and lo): lo.hi + hi.lo + hi.hi
// into a fresh partial, which is then added to d rounding to nearest.
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, bh[0], bh[1]);
  mma_tf32(p, ah, bl[0], bl[1]);
  mma_tf32(p, ah, bh[0], bh[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
}

// The split A fragment of a warp's 16 staged query rows (LDS words apart)
// at k-step kk: a0 / a2 row g, dims 8kk + 2t / + 1; a1 / a3 row g + 8.
template <int LDS>
__device__ __forceinline__ void load_q_tf32(uint32_t (&ah)[4], uint32_t (&al)[4],
                                            const float* Qs, int kk, int lane) {
  const int g = lane / 4, t = lane % 4;
  const float2 r0 = *reinterpret_cast<const float2*>(Qs + g * LDS + kk * 8 + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(Qs + (g + 8) * LDS + kk * 8 + 2 * t);
  split_tf32(r0.x, ah[0], al[0]);
  split_tf32(r1.x, ah[1], al[1]);
  split_tf32(r0.y, ah[2], al[2]);
  split_tf32(r1.y, ah[3], al[3]);
}

// s += k-step kk of the unscaled scores of the warp's 16 rows against 8
// staged keys (Ks at the tile's first key, rows LDS words apart), in the
// accumulator layout: s[0], s[1] row g, keys 2t, 2t + 1; s[2], s[3] row
// g + 8.
template <int LDS>
__device__ __forceinline__ void qk_step_tf32(float (&s)[4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], const float* Ks, int kk,
                                             int lane) {
  const int g = lane / 4, t = lane % 4;
  const float2 kv = *reinterpret_cast<const float2*>(Ks + g * LDS + kk * 8 + 2 * t);
  uint32_t bh[2], bl[2];
  split_tf32(kv.x, bh[0], bl[0]);
  split_tf32(kv.y, bh[1], bl[1]);
  mma3_tf32(s, ah, al, bh, bl);
}

// o += P . V over 8 staged keys for ND 8-column steps of the output (Vs
// at the tile's first key and first column, rows LDS words apart), the
// steps at or past `dims` columns skipped; p: the tile's probabilities in
// qk_step_tf32's layout. o[nd] holds columns 8nd + 2t, + 1 of rows g
// (o[nd][0], [1]) and g + 8.
template <int LDS, int ND>
__device__ __forceinline__ void pv_tile_tf32(float (&o)[ND][4], const float (&p)[4],
                                             const float* Vs, int lane, int dims = ND * 8) {
  const int g = lane / 4, t = lane % 4;
  uint32_t ah[4], al[4];  // the key permutation: A = (c0, c2, c1, c3)
  split_tf32(p[0], ah[0], al[0]);
  split_tf32(p[2], ah[1], al[1]);
  split_tf32(p[1], ah[2], al[2]);
  split_tf32(p[3], ah[3], al[3]);
  const float* v0 = Vs + 2 * t * LDS + g;  // key 2t; key 2t + 1 a row on
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (nd * 8 < dims) {
      uint32_t bh[2], bl[2];
      split_tf32(v0[nd * 8], bh[0], bl[0]);
      split_tf32(v0[LDS + nd * 8], bh[1], bl[1]);
      mma3_tf32(o[nd], ah, al, bh, bl);
    }
  }
}

}  // namespace fern
