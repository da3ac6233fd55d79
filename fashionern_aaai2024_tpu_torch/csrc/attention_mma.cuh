// bf16 tensor-core tiles of the port's attention kernels: a warp holds
// 16 query rows and runs `mma.sync.m16n8k16` (bf16 operands, fp32
// accumulators) over 16-key tiles staged in shared memory.
//
// Shared by the attention core (attention_core.cuh: kernels B1, B3, B6-B10
// and X2-X4 in bf16) and the grouped kernel (attention_grouped.cu: X1 and
// B9's long keys in bf16).
//
//   * Staging: global -> shared through `cp.async` 16-byte copies
//     (`cp.async.cg`, L2 only) when the operand's base, head offset and
//     row stride are multiples of 16 bytes; 4-byte copies (`cp.async.ca`)
//     when they are multiples of 4; element copies otherwise. The launcher
//     picks the width from the pointers and strides (`staging_width`).
//     Rows and columns past the operand are zero-filled.
//   * Shared rows are D + 8 elements (16 bytes more than a head), so the
//     eight 16-byte rows one `ldmatrix` phase reads start in eight
//     different groups of four banks: 36 words apart at D = 64 (banks 4r),
//     44 at D = 80 (12r mod 32), 68 at D = 128 (4r).
//   * Q fragments are loaded once a tile with `ldmatrix`; S = Q K^T is
//     two m16n8k16 products a 16-key tile and k-step (D / 16 k-steps);
//     the accumulator of S is laid out as the A operand of P . V (row g
//     and g + 8, keys 2t, 2t + 1 and 2t + 8, 2t + 9 of lane 4g + t), so P
//     goes from registers, rounded to bf16, into the P . V product, whose
//     B operand (V) is read with `ldmatrix.trans`.
//   * Row statistics: each lane holds two rows (g and g + 8); a row's max
//     and sum are reduced over the four lanes of its quad.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace fern {

constexpr int kMmaRows = 16;  // query rows of a warp tile (the mma's M)
constexpr int kKeyTile = 16;  // keys of one P . V k-step

// Shared row stride of a staged [rows, D] bf16 tile, in elements.
__host__ __device__ constexpr int mma_lds(int d) { return d + 8; }

// Widest copy every row of an operand allows: 16, 4 or 2 bytes. `ptrs`
// are the operands' first-head addresses; `strides` their row strides
// and the head width, in bf16 elements (head h starts h * D further).
inline int staging_width(std::initializer_list<const void*> ptrs,
                         std::initializer_list<long long> strides) {
  unsigned long long any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<unsigned long long>(p);
  for (long long s : strides) any |= static_cast<unsigned long long>(s) * 2;
  if (any % 16 == 0) return 16;
  if (any % 4 == 0) return 4;
  return 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy through L1; with pred false the 4 bytes are
// zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}
// Commits this thread's outstanding copies and waits for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// p / l, bit for bit the IEEE fp32 quotient, from rl = 1 / l in double
// (one division a row): the double product lies within 2^-52 of p / l
// (relative), and a quotient of two floats is either a float midpoint
// exactly (never: 2M + 1 times l has more than 24 bits) or at least 2^-49
// (relative) away from every midpoint, so rounding the product to fp32
// rounds p / l. Three instructions against a division's subroutine.
__device__ __forceinline__ float div_rn(float p, double rl) {
  return __double2float_rn(__dmul_rn(static_cast<double>(p), rl));
}

// A tile's probabilities p / l (p: exp(s - m) in qk_tile's layout; rl0 =
// 1 / l0 for rows g, rl1 for rows g + 8) rounded to bf16 pairs, the A
// operand of the P . V product.
__device__ __forceinline__ void probs_bf16(unsigned (&pa)[4], const float (&p)[8], double rl0,
                                           double rl1) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const double rl = c % 2 ? rl1 : rl0;
    pa[c] = pack_bf16(div_rn(p[2 * c], rl), div_rn(p[2 * c + 1], rl));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [0, rows_pad) x columns [0, DP) of a shared tile at row stride
// mma_lds(DP): rows [0, rows) and columns [0, cols) from `src` at row
// stride `ld`, zeros elsewhere. Thread `tid` of `nthreads` takes every
// nthreads-th copy; `width` is the launcher's staging width (16 needs
// cols % 8 == 0, 4 needs cols even). Copies of width 16 and 4 are
// asynchronous: the caller commits and waits.
template <int DP>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src, int ld,
                                           int rows, int rows_pad, int cols, int width,
                                           int tid, int nthreads) {
  constexpr int lds = mma_lds(DP);
  if (width == 16) {
    constexpr int kUnits = DP / 8;
    for (int u = tid; u < rows_pad * kUnits; u += nthreads) {
      const int r = u / kUnits, c = (u % kUnits) * 8;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * lds + c, in ? src + (size_t)r * ld + c : src, in);
    }
  } else if (width == 4) {
    constexpr int kUnits = DP / 2;
    for (int u = tid; u < rows_pad * kUnits; u += nthreads) {
      const int r = u / kUnits, c = (u % kUnits) * 2;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * lds + c, in ? src + (size_t)r * ld + c : src, in);
    }
  } else {
    for (int u = tid; u < rows_pad * DP; u += nthreads) {
      const int r = u / DP, c = u % DP;
      dst[r * lds + c] = r < rows && c < cols ? src[(size_t)r * ld + c] : from_f<bf16>(0.f);
    }
  }
}

// The A fragments of a warp's 16 staged query rows, D / 16 k-steps.
template <int DP>
__device__ __forceinline__ void load_q_frags(unsigned (&qf)[DP / 16][4], const bf16* Qs,
                                             int lane) {
  const bf16* p = Qs + (lane % 16) * mma_lds(DP) + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qf[kk], p + kk * 16);
}

// Unscaled scores of the warp's 16 rows against 16 staged keys (Ks at the
// tile's first key): s[0..3] keys 0-7, s[4..7] keys 8-15, as the
// accumulator layout (s[0], s[1]: row g, keys 2t, 2t+1; s[2], s[3]: row
// g + 8).
template <int DP>
__device__ __forceinline__ void qk_tile(float (&s)[8], const unsigned (&qf)[DP / 16][4],
                                        const bf16* Ks, int lane) {
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = 0.f;
  const bf16* p = Ks + ((lane % 8) + 8 * (lane / 16)) * mma_lds(DP) + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    unsigned b[4];
    ldmatrix_x4(b, p + kk * 16);
    mma_bf16(s, qf[kk], b[0], b[1]);
    mma_bf16(s + 4, qf[kk], b[2], b[3]);
  }
}

// o += P . V over 16 staged keys (Vs at the tile's first key); p: the
// tile's probabilities in qk_tile's layout, already rounded to bf16 pairs
// (pa[0]: row g keys 2t, 2t+1; pa[1]: row g + 8; pa[2], pa[3]: keys 8 on).
template <int DP>
__device__ __forceinline__ void pv_tile(float (&o)[DP / 8][4], const unsigned (&pa)[4],
                                        const bf16* Vs, int lane) {
  const bf16* p = Vs + (lane % 16) * mma_lds(DP) + (lane / 16) * 8;
#pragma unroll
  for (int nd = 0; nd < DP / 16; ++nd) {
    unsigned b[4];
    ldmatrix_x4_trans(b, p + nd * 16);
    mma_bf16(o[2 * nd], pa, b[0], b[1]);
    mma_bf16(o[2 * nd + 1], pa, b[2], b[3]);
  }
}

// One output pair (columns d, d + 1) of a row, in the output's type.
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The scaled score plus the bias, each rounded on its own as the plain
// version rounds them (no fused multiply-add, so every instance of the
// tiles gives the same bits).
template <bool kBias>
__device__ __forceinline__ float scaled_score(float dot, float scale,
                                              const float* __restrict__ brow, int j) {
  if constexpr (kBias)
    return __fadd_rn(__fmul_rn(dot, scale), brow != nullptr ? brow[j] : 0.f);
  else
    return __fmul_rn(dot, scale);
}

}  // namespace fern
