// Row quantization to int8 for kernels B5 (int8 MLP sub-block) and B6
// (int8 attention sub-block).
//
// Replaces: the prologue of `_qmlp_kernel` and `_qattn_kernel`
// (fashionern_aaai2024_tpu/ops/qmlp.py:53-60 and :171-178: fp32 LN, then
// `_quant_rows_f32`), the per-chunk quantization of B5's hidden
// (`qmlp.py:71-72`) and of B6's attention output (`qmlp.py:202`).
//
//   fern_ln_quant:     x [R, W] (fp32 or bf16) -> LN in fp32 -> int8 [R, W]
//                      + one fp32 scale per row;
//   fern_quant_groups: fp32 [R, F] -> int8 [R, F] + fp32 scales [R, G],
//                      one scale per row and per group of F / G columns.
//
// The rule (`qmlp.py:42-47`, `qmatmul.py:28-33`): scale = max(absmax,
// 1e-8) / 127, q = clip(round(v / scale), -127, 127), round half to even
// (`rintf`), a true IEEE division (`__fdiv_rn`, never a reciprocal
// multiply). The LN's products and sums are rounded one at a time
// (`__fmul_rn`, `__fadd_rn`, no FMA contraction), in the order
// `xc * rsqrt(var + eps) * g + b` of the Pallas kernel, the variance in
// two passes (the mean of squared deviations), so that the only
// difference from the plain PyTorch version is the summation order of
// the mean and variance; that can still move a value across a rounding
// boundary, and then one int8 code differs by one step.
//
// Bound: device-memory bandwidth (read the row once, write a quarter of
// its bytes in int8 for an fp32 row, half for a bf16 one).
// Design: one warp a row (or a row's group), on the vector routine of
// B11 (`layernorm_row.cuh`): the row in registers as 16-byte vectors, lane
// l holding vectors l, l + 32, ...; the sums, the variance and the absmax
// reduced by warp shuffles (no shared memory, no block barrier); the int8
// codes of a vector written from registers as one 4- or 8-byte word (a
// warp's store is 128 or 256 contiguous bytes). LN parameters are loaded
// once a warp. Each warp walks rows with a grid stride, the grid as many
// blocks as the SMs keep resident (or fewer, one warp a row), and loads
// its next row while it reduces the current one. One
// instance per vectors-a-lane count (LN: 1-8, W up to 1,024 fp32 / 2,048
// bf16; groups: 1-12, up to 1,536 fp32 columns, B5's group at ViT-B-16);
// any other width or alignment takes the general instance of the same
// kernel, one element a lane a step over the row in global memory.

#include "layernorm_row.cuh"

namespace fern {

constexpr int kQuantThreads = 256;
constexpr int kQuantWarps = kQuantThreads / 32;
constexpr int kGroupMaxVpl = 12;

__device__ __forceinline__ float scale_of(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.f);
}

__device__ __forceinline__ int quantize_one(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// Four codes as one little-endian word.
__device__ __forceinline__ uint32_t pack_codes(const float* y, float scale) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) w |= (uint32_t)(quantize_one(y[e], scale) & 0xff) << (8 * e);
  return w;
}

// The V codes of one vector of V values at q (4 or 8 bytes, aligned).
template <int V>
__device__ __forceinline__ void store_codes(signed char* q, const float (&y)[V], float scale) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(q) = pack_codes(y, scale);
  } else {
    *reinterpret_cast<uint2*>(q) = make_uint2(pack_codes(y, scale), pack_codes(y + 4, scale));
  }
}

// ---- LN + quantize -----------------------------------------------------

// The LN'd element e of vector i of a row held by a lane.
template <typename T, int VPL>
__device__ __forceinline__ float ln_elem(const LnRow<T, VPL>& ln, const uint4 (&x)[VPL], int i,
                                         int e, float mean, float inv) {
  const float d = __fsub_rn(vec_elem<T>(x[i], e), mean);
  return __fadd_rn(__fmul_rn(__fmul_rn(d, inv), vec_elem<T>(ln.g[i], e)),
                   vec_elem<T>(ln.b[i], e));
}

// A lane's VPL 16-byte vectors of a row (zero past its nvec vectors).
template <int VPL, typename T>
__device__ __forceinline__ void load_row(uint4 (&xv)[VPL], const T* xr, int nvec, int lane) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    xv[i] = v < nvec ? ld16(xr + (size_t)v * V) : make_uint4(0, 0, 0, 0);
  }
}

// Rows first_row, first_row + row_step, ... by one warp, each row in
// registers (VPL 16-byte vectors a lane); the next row's loads are in
// flight while this one reduces.
template <typename T, int VPL>
__device__ __forceinline__ void ln_quant_rows_vec(const T* x, const T* g, const T* b,
                                                  signed char* q, float* scale, int rows,
                                                  int width, float eps, int first_row,
                                                  int row_step, int lane) {
  constexpr int V = LnVec<T>::N;
  const int nvec = width / V;
  LnRow<T, VPL> ln;
  ln.load_params(g, b, nvec, lane);
  uint4 next[VPL];
  if (first_row < rows) load_row(next, x + (size_t)first_row * width, nvec, lane);
  for (int r = first_row; r < rows; r += row_step) {
    uint4 xv[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) xv[i] = next[i];
    if (r + row_step < rows) load_row(next, x + (size_t)(r + row_step) * width, nvec, lane);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) s = __fadd_rn(s, vec_elem<T>(xv[i], e));
    const float mean = __fdiv_rn(warp_sum(s), (float)width);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = __fsub_rn(vec_elem<T>(xv[i], e), mean);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
    const float var = __fdiv_rn(warp_sum(sq), (float)width);
    const float inv = __frsqrt_rn(__fadd_rn(var, eps));
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(ln_elem(ln, xv, i, e, mean, inv)));
    const float sc = scale_of(warp_max(amax));
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v >= nvec) continue;
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = ln_elem(ln, xv, i, e, mean, inv);
      store_codes<V>(q + (size_t)r * width + (size_t)v * V, y, sc);
    }
    if (lane == 0) scale[r] = sc;
  }
}

// The general routine: any width and alignment, one element a lane a
// step, the row read from global memory in each pass.
template <typename T>
__device__ __forceinline__ void ln_quant_rows_any(const T* x, const T* g, const T* b,
                                                  signed char* q, float* scale, int rows,
                                                  int width, float eps, int first_row,
                                                  int row_step, int lane) {
  for (int r = first_row; r < rows; r += row_step) {
    const T* xr = x + (size_t)r * width;
    float s = 0.f;
    for (int c = lane; c < width; c += 32) s = __fadd_rn(s, to_f(xr[c]));
    const float mean = __fdiv_rn(warp_sum(s), (float)width);
    float sq = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float d = __fsub_rn(to_f(xr[c]), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)width), eps));
    auto y = [&](int c) {
      const float d = __fsub_rn(to_f(xr[c]), mean);
      return __fadd_rn(__fmul_rn(__fmul_rn(d, inv), to_f(g[c])), to_f(b[c]));
    };
    float amax = 0.f;
    for (int c = lane; c < width; c += 32) amax = fmaxf(amax, fabsf(y(c)));
    const float sc = scale_of(warp_max(amax));
    for (int c = lane; c < width; c += 32)
      q[(size_t)r * width + c] = static_cast<signed char>(quantize_one(y(c), sc));
    if (lane == 0) scale[r] = sc;
  }
}

// VPL 0: the general routine.
template <typename T, int VPL>
__global__ void __launch_bounds__(kQuantThreads)
ln_quant_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                signed char* __restrict__ q, float* __restrict__ scale, int rows, int width,
                float eps) {
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int step = gridDim.x * kQuantWarps;
  if constexpr (VPL > 0)
    ln_quant_rows_vec<T, VPL>(x, g, b, q, scale, rows, width, eps, warp, step, lane);
  else
    ln_quant_rows_any(x, g, b, q, scale, rows, width, eps, warp, step, lane);
}

// ---- quantize in column groups -----------------------------------------

// The row groups w = first, first + step, ... (row w / groups, group w %
// groups of c columns) by one warp, each group in registers, the next
// group's loads in flight while this one reduces.
template <int VPL>
__device__ __forceinline__ void quant_groups_vec(const float* x, signed char* q, float* scale,
                                                 int count, int width, int groups, int first,
                                                 int step, int lane) {
  const int c = width / groups, nvec = c / 4;
  auto base_of = [&](int w) {
    return (size_t)(w / groups) * width + (size_t)(w % groups) * c;
  };
  uint4 next[VPL];
  if (first < count) load_row(next, x + base_of(first), nvec, lane);
  for (int w = first; w < count; w += step) {
    const size_t base = base_of(w);
    uint4 xv[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) xv[i] = next[i];
    if (w + step < count) load_row(next, x + base_of(w + step), nvec, lane);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(vec_elem<float>(xv[i], e)));
    const float sc = scale_of(warp_max(amax));
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v >= nvec) continue;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = vec_elem<float>(xv[i], e);
      store_codes<4>(q + base + (size_t)v * 4, y, sc);
    }
    if (lane == 0) scale[w] = sc;
  }
}

__device__ __forceinline__ void quant_groups_any(const float* x, signed char* q, float* scale,
                                                 int count, int width, int groups, int first,
                                                 int step, int lane) {
  const int c = width / groups;
  for (int w = first; w < count; w += step) {
    const size_t base = (size_t)(w / groups) * width + (size_t)(w % groups) * c;
    float amax = 0.f;
    for (int i = lane; i < c; i += 32) amax = fmaxf(amax, fabsf(x[base + i]));
    const float sc = scale_of(warp_max(amax));
    for (int i = lane; i < c; i += 32)
      q[base + i] = static_cast<signed char>(quantize_one(x[base + i], sc));
    if (lane == 0) scale[w] = sc;
  }
}

// VPL 0: the general routine. count = rows x groups; the scale of row r,
// group g lands at r * groups + g.
template <int VPL>
__global__ void __launch_bounds__(kQuantThreads)
quant_groups_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                    float* __restrict__ scale, int count, int width, int groups) {
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int step = gridDim.x * kQuantWarps;
  if constexpr (VPL > 0)
    quant_groups_vec<VPL>(x, q, scale, count, width, groups, warp, step, lane);
  else
    quant_groups_any(x, q, scale, count, width, groups, warp, step, lane);
}

// Vectors a lane of the group routine, or 0 for the general one: groups
// of c % 4 == 0 fp32 columns with x and q 16-byte aligned, up to
// kGroupMaxVpl vectors a lane.
inline int quant_groups_vpl(const void* x, const void* q, int width, int groups) {
  const int c = width / groups;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q);
  if (c <= 0 || c % 4 || addr % 16) return 0;
  const int vpl = (c / 4 + 31) / 32;
  return vpl <= kGroupMaxVpl ? vpl : 0;
}

// One warp a unit of work (a row, or a row's group), at most the resident blocks.
template <auto Kernel>
static int grid_of(int units, int device) {
  const int wanted = (units + kQuantWarps - 1) / kQuantWarps;
  const int resident = max_resident_blocks<Kernel>(device, kQuantThreads);
  return wanted < resident ? wanted : resident;
}

template <typename T, int VPL>
static cudaError_t launch_ln_quant(const void* x, const void* g, const void* b, void* q,
                                   void* scale, int rows, int width, float eps, int device,
                                   cudaStream_t stream) {
  constexpr auto kernel = ln_quant_kernel<T, VPL>;
  kernel<<<grid_of<kernel>(rows, device), kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<signed char*>(q), static_cast<float*>(scale), rows, width, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t ln_quant_dispatch(const void* x, const void* g, const void* b, void* q,
                                     void* scale, int rows, int width, float eps, int device,
                                     cudaStream_t stream) {
  // the codes of a vector go out as one word: q's rows are aligned as x's
  switch (layernorm_vpl<T>(x, g, b, q, width)) {
#define FERN_LNQ_LAUNCH(VPL) \
  case VPL:                  \
    return launch_ln_quant<T, VPL>(x, g, b, q, scale, rows, width, eps, device, stream);
    FERN_LNQ_LAUNCH(1) FERN_LNQ_LAUNCH(2) FERN_LNQ_LAUNCH(3) FERN_LNQ_LAUNCH(4)
    FERN_LNQ_LAUNCH(5) FERN_LNQ_LAUNCH(6) FERN_LNQ_LAUNCH(7) FERN_LNQ_LAUNCH(8)
#undef FERN_LNQ_LAUNCH
    default:
      return launch_ln_quant<T, 0>(x, g, b, q, scale, rows, width, eps, device, stream);
  }
}

template <int VPL>
static cudaError_t launch_quant_groups(const void* x, void* q, void* scale, int rows, int width,
                                       int groups, int device, cudaStream_t stream) {
  constexpr auto kernel = quant_groups_kernel<VPL>;
  const int count = rows * groups;
  kernel<<<grid_of<kernel>(count, device), kQuantThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q), static_cast<float*>(scale),
      count, width, groups);
  return cudaGetLastError();
}

}  // namespace fern

// x, q: [rows, width] contiguous; g, b: [width]; x, g, b of type `dtype`;
// scale: fp32 [rows].
extern "C" int fern_ln_quant(const void* x, const void* g, const void* b, void* q, void* scale,
                             int rows, int width, float eps, int dtype, int device,
                             void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (width < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16)
    return (int)fern::ln_quant_dispatch<fern::bf16>(x, g, b, q, scale, rows, width, eps,
                                                    device, s);
  if (dtype == fern::DTYPE_F32)
    return (int)fern::ln_quant_dispatch<float>(x, g, b, q, scale, rows, width, eps, device, s);
  return (int)cudaErrorInvalidValue;
}

// x: fp32 [rows, width], q: int8 [rows, width], both contiguous; scale:
// fp32 [rows, groups]; groups divides width.
extern "C" int fern_quant_groups(const void* x, void* q, void* scale, int rows, int width,
                                 int groups, int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (groups <= 0 || width % groups) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fern::quant_groups_vpl(x, q, width, groups)) {
#define FERN_QG_LAUNCH(VPL) \
  case VPL:                 \
    return (int)fern::launch_quant_groups<VPL>(x, q, scale, rows, width, groups, device, s);
    FERN_QG_LAUNCH(1) FERN_QG_LAUNCH(2) FERN_QG_LAUNCH(3) FERN_QG_LAUNCH(4)
    FERN_QG_LAUNCH(5) FERN_QG_LAUNCH(6) FERN_QG_LAUNCH(7) FERN_QG_LAUNCH(8)
    FERN_QG_LAUNCH(9) FERN_QG_LAUNCH(10) FERN_QG_LAUNCH(11) FERN_QG_LAUNCH(12)
#undef FERN_QG_LAUNCH
    default:
      return (int)fern::launch_quant_groups<0>(x, q, scale, rows, width, groups, device, s);
  }
}
