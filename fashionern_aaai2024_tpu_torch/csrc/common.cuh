// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Element types are passed across the C interface as an int code:
// DTYPE_F32 = 0, DTYPE_BF16 = 1. Every kernel computes in fp32 and
// rounds to the storage type only where the Pallas kernels it replaces
// round (fashionern_aaai2024_tpu/ops/attention.py:484-515,
// ops/mlp.py:94-115).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fern {

enum DType : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };
enum Act : int { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Round an fp32 value through the storage type and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Activations in fp32, as ops/mlp.py:50 `_act_f32`.
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_QUICK_GELU) return v * (1.0f / (1.0f + expf(-1.702f * v)));
  if (act == ACT_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  return v;
}

// GEMM epilogue for one output element: bias is added to the fp32
// accumulator, the activation runs in fp32, the result is cast to the
// storage type, and only then is the residual added (in the storage
// type, as `x + proj.astype(x.dtype)` does).
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, const T* res,
                                      size_t idx, int col, int act) {
  float v = acc;
  if (bias != nullptr) v += to_f(bias[col]);
  v = apply_act(v, act);
  if (res == nullptr) return from_f<T>(v);
  return from_f<T>(to_f(res[idx]) + round_to<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace fern
