// LayerNorm rows, one warp a row: fp32 mean, then the two-pass variance
// (mean of squared deviations) as the Pallas kernel computes it
// (fashionern_aaai2024_tpu/ops/layernorm.py:27-34 `_ln_kernel`), then
// (x - mean) * rsqrt(var + eps) * gamma + beta rounded to the storage
// type.
//
// Shared by layernorm.cu (kernel B11 and the LN launches of B1 / B2) and
// block.cu (kernel B10's two LNs), which must give the same bits: B10 is
// held bit for bit to B1 + B2. So both run `layernorm_rows` below, which
// picks the routine from the width and the pointers alone, and every
// rounding step is an explicit intrinsic (no contraction left to the
// compiler). Each .cu file compiles in its own nvcc process, so the
// routines live here as inline device functions.
//
// The vector routine (`LnRow<T, VPL>`): a row of W elements is W / V
// 16-byte vectors (V = 4 fp32 or 8 bf16); lane l holds vectors l, l + 32,
// ..., VPL of them at most, in registers, read once with 16-byte loads
// (a warp's load is 512 contiguous bytes) and written back with 16-byte
// stores. A lane sums its own elements in vector order, then the warp
// sums by shuffles. Gamma and beta are loaded once a warp, into
// registers, for every row it walks. It needs W % V == 0, W / V <= 32 *
// VPL and 16-byte aligned rows; any other width or alignment takes the
// general routine (one element a lane a step, three passes over the row
// in global memory).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace fern {

constexpr int kLnMaxVpl = 8;  // vector instances: 1..8 vectors a lane

template <typename T> struct LnVec;
template <> struct LnVec<float> { static constexpr int N = 4; };
template <> struct LnVec<bf16> { static constexpr int N = 8; };

// Element e of a 16-byte vector, exactly, as fp32.
template <typename T> __device__ __forceinline__ float vec_elem(const uint4& v, int e);
template <> __device__ __forceinline__ float vec_elem<float>(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[e]);
}
template <> __device__ __forceinline__ float vec_elem<bf16>(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[e / 2];
  return __uint_as_float(e % 2 ? word & 0xffff0000u : word << 16);
}

// Two fp32 values rounded to bf16 (round to nearest even), in one word.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <typename T>
__device__ __forceinline__ uint4 vec_pack(const float (&y)[LnVec<T>::N]);
template <> __device__ __forceinline__ uint4 vec_pack<float>(const float (&y)[4]) {
  return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]),
                    __float_as_uint(y[3]));
}
template <> __device__ __forceinline__ uint4 vec_pack<bf16>(const float (&y)[8]) {
  return make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]), pack_bf16x2(y[4], y[5]),
                    pack_bf16x2(y[6], y[7]));
}

// A plain 16-byte load: B10 reads rows that other blocks of its launch
// wrote, so nothing here asks for the read-only cache.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// One warp's rows in registers: VPL 16-byte vectors a lane.
template <typename T, int VPL>
struct LnRow {
  static constexpr int V = LnVec<T>::N;
  uint4 g[VPL], b[VPL];

  __device__ __forceinline__ void load_params(const T* gamma, const T* beta, int nvec,
                                              int lane) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      g[i] = v < nvec ? ld16(gamma + (size_t)v * V) : make_uint4(0, 0, 0, 0);
      b[i] = v < nvec ? ld16(beta + (size_t)v * V) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void run(const T* xr, T* yr, int width, int nvec, float eps,
                                      int lane) const {
    uint4 x[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      x[i] = v < nvec ? ld16(xr + (size_t)v * V) : make_uint4(0, 0, 0, 0);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) s = __fadd_rn(s, vec_elem<T>(x[i], e));
    const float mean = __fdiv_rn(warp_sum(s), (float)width);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = __fsub_rn(vec_elem<T>(x[i], e), mean);
          q = __fmaf_rn(d, d, q);
        }
    const float inv = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)width), eps));
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v >= nvec) continue;
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = __fsub_rn(vec_elem<T>(x[i], e), mean);
        y[e] = __fmaf_rn(__fmul_rn(d, inv), vec_elem<T>(g[i], e), vec_elem<T>(b[i], e));
      }
      *reinterpret_cast<uint4*>(yr + (size_t)v * V) = vec_pack<T>(y);
    }
  }
};

// Rows first_row, first_row + row_step, ... of a [rows, width] matrix by
// one warp on the vector routine with VPL vectors a lane.
template <typename T, int VPL>
__device__ __forceinline__ void layernorm_rows_vec(const T* x, const T* g, const T* b, T* y,
                                                   int rows, int width, float eps,
                                                   int first_row, int row_step, int lane) {
  const int nvec = width / LnVec<T>::N;
  LnRow<T, VPL> ln;
  ln.load_params(g, b, nvec, lane);
  for (int r = first_row; r < rows; r += row_step)
    ln.run(x + (size_t)r * width, y + (size_t)r * width, width, nvec, eps, lane);
}

// The general routine: any width and alignment, one element a lane a step.
template <typename T>
__device__ __forceinline__ void layernorm_row_any(const T* xr, const T* g, const T* b, T* yr,
                                                  int width, float eps, int lane) {
  float s = 0.f;
  for (int c = lane; c < width; c += 32) s = __fadd_rn(s, to_f(xr[c]));
  const float mean = __fdiv_rn(warp_sum(s), (float)width);
  float q = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float d = __fsub_rn(to_f(xr[c]), mean);
    q = __fmaf_rn(d, d, q);
  }
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)width), eps));
  for (int c = lane; c < width; c += 32) {
    const float d = __fsub_rn(to_f(xr[c]), mean);
    yr[c] = from_f<T>(__fmaf_rn(__fmul_rn(d, inv), to_f(g[c]), to_f(b[c])));
  }
}

template <typename T>
__device__ __forceinline__ void layernorm_rows_any(const T* x, const T* g, const T* b, T* y,
                                                   int rows, int width, float eps,
                                                   int first_row, int row_step, int lane) {
  for (int r = first_row; r < rows; r += row_step)
    layernorm_row_any(x + (size_t)r * width, g, b, y + (size_t)r * width, width, eps, lane);
}

// Vectors a lane of the vector routine for these operands, or 0 for the
// general routine. The host (layernorm.cu) and the device (block.cu)
// decide by this one rule.
template <typename T>
__host__ __device__ __forceinline__ int layernorm_vpl(const void* x, const void* g,
                                                      const void* b, const void* y,
                                                      int width) {
  constexpr int V = LnVec<T>::N;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y);
  if (width <= 0 || width % V || addr % 16) return 0;
  const int vpl = (width / V + 31) / 32;
  return vpl <= kLnMaxVpl ? vpl : 0;
}

// One warp's rows by the rule above (kernel B10's LN phases).
template <typename T>
__device__ __forceinline__ void layernorm_rows(const T* x, const T* g, const T* b, T* y,
                                               int rows, int width, float eps, int first_row,
                                               int row_step, int lane) {
  switch (layernorm_vpl<T>(x, g, b, y, width)) {
#define FERN_LN_CASE(VPL)                                                               \
  case VPL:                                                                             \
    layernorm_rows_vec<T, VPL>(x, g, b, y, rows, width, eps, first_row, row_step, lane); \
    return;
    FERN_LN_CASE(1) FERN_LN_CASE(2) FERN_LN_CASE(3) FERN_LN_CASE(4)
    FERN_LN_CASE(5) FERN_LN_CASE(6) FERN_LN_CASE(7) FERN_LN_CASE(8)
#undef FERN_LN_CASE
    default:
      layernorm_rows_any(x, g, b, y, rows, width, eps, first_row, row_step, lane);
  }
}

}  // namespace fern
