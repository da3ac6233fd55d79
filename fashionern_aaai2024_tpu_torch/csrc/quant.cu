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
// `xc * rsqrt(var + eps) * g + b` of the Pallas kernel, so that the only
// difference from the plain PyTorch version is the summation order of
// the mean and variance; that can still move a value across a rounding
// boundary, and then one int8 code differs by one step.
//
// Bound: device-memory bandwidth (read the row once, write a quarter of
// its bytes in int8). Design: one block of 256 threads per row (or per
// row group), the LN'd row kept in shared memory between the absmax and
// the quantization pass, block reductions through warp shuffles and an
// 8-slot shared array.

#include "common.cuh"

namespace fern {

constexpr int kQuantThreads = 256;

// Sum (or max) over the block; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* slots) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the slots may still be read by a previous reduction
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  float r = lane < kQuantThreads / 32 ? slots[lane] : 0.f;  // max: of values >= 0
  r = kMax ? warp_max(r) : warp_sum(r);
  return r;
}

__device__ __forceinline__ signed char quantize_one(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return static_cast<signed char>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float scale_of(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
ln_quant_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                signed char* __restrict__ q, float* __restrict__ scale, int width, float eps) {
  extern __shared__ float y[];  // the LN'd row, fp32
  __shared__ float slots[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * width;
  float s = 0.f;
  for (int c = threadIdx.x; c < width; c += kQuantThreads) s += to_f(xr[c]);
  const float mean = __fdiv_rn(block_reduce<false>(s, slots), (float)width);
  float v = 0.f;
  for (int c = threadIdx.x; c < width; c += kQuantThreads) {
    const float d = __fsub_rn(to_f(xr[c]), mean);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_reduce<false>(v, slots), (float)width);
  const float inv = __frsqrt_rn(__fadd_rn(var, eps));
  float amax = 0.f;
  for (int c = threadIdx.x; c < width; c += kQuantThreads) {
    const float d = __fsub_rn(to_f(xr[c]), mean);
    const float yc = __fadd_rn(__fmul_rn(__fmul_rn(d, inv), to_f(g[c])), to_f(b[c]));
    y[c] = yc;
    amax = fmaxf(amax, fabsf(yc));
  }
  const float sc = scale_of(block_reduce<true>(amax, slots));
  for (int c = threadIdx.x; c < width; c += kQuantThreads)
    q[row * width + c] = quantize_one(y[c], sc);
  if (threadIdx.x == 0) scale[row] = sc;
}

// grid (rows, groups): block (r, g) quantizes columns [g*c, (g+1)*c) of row r.
__global__ void __launch_bounds__(kQuantThreads)
quant_groups_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                    float* __restrict__ scale, int width, int groups) {
  __shared__ float slots[kQuantThreads / 32];
  const int group = blockIdx.y, c = width / groups;
  const size_t base = (size_t)blockIdx.x * width + (size_t)group * c;
  float amax = 0.f;
  for (int i = threadIdx.x; i < c; i += kQuantThreads) amax = fmaxf(amax, fabsf(x[base + i]));
  const float sc = scale_of(block_reduce<true>(amax, slots));
  for (int i = threadIdx.x; i < c; i += kQuantThreads) q[base + i] = quantize_one(x[base + i], sc);
  if (threadIdx.x == 0) scale[(size_t)blockIdx.x * groups + group] = sc;
}

}  // namespace fern

extern "C" int fern_ln_quant(const void* x, const void* g, const void* b, void* q, void* scale,
                             int rows, int width, float eps, int dtype, int device,
                             void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)width * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  auto* qo = static_cast<signed char*>(q);
  auto* so = static_cast<float*>(scale);
  if (dtype == fern::DTYPE_BF16) {
    using fern::bf16;
    fern::ln_quant_kernel<bf16><<<rows, fern::kQuantThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(b),
        qo, so, width, eps);
    return (int)cudaGetLastError();
  }
  if (dtype == fern::DTYPE_F32) {
    fern::ln_quant_kernel<float><<<rows, fern::kQuantThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), qo, so, width, eps);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int fern_quant_groups(const void* x, void* q, void* scale, int rows, int width,
                                 int groups, int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (groups <= 0 || width % groups) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  dim3 grid(rows, groups);
  fern::quant_groups_kernel<<<grid, fern::kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q), static_cast<float*>(scale),
      width, groups);
  return (int)cudaGetLastError();
}
