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
#include <stdint.h>

#include <atomic>

namespace fern {

enum DType : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };
enum Act : int { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2, ACT_RELU = 3 };

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

// Activations in fp32, as ops/mlp.py:50 `_act_f32`; ReLU for the
// combiner's projections (ops/combiner.py:38-49).
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_QUICK_GELU) return v * (1.0f / (1.0f + expf(-1.702f * v)));
  if (act == ACT_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (act == ACT_RELU) return fmaxf(v, 0.0f);
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

// The split of an fp32 operand of the 3xTF32 products on the tensor cores
// (gemm_tf32.cuh, attention_tf32.cuh): x = hi + lo, hi = tf32_rna(x),
// lo = tf32_lo(x, hi).
//
// x rounded to tf32 as `cvt.rna.tf32.f32` rounds (to nearest, ties away
// from zero), as an fp32 value with the low 13 mantissa bits zero: half
// of the dropped bits is added to the magnitude, then they are cleared.
// Two integer operations; the same bits as cvt.rna for every finite x and
// for infinities.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// lo = tf32(x - hi) of x = hi + lo, hi = tf32(x) given.
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
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

// ---- host side of every C entry point ----------------------------------

constexpr int kMaxDevices = 64;

// Makes `device` current, unless it already is: the first step of every
// C entry point, which launches from the caller's thread.
inline cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// SM count of a device (in range: `use_device` checked it), read once.
inline int sm_count(int device) {
  static std::atomic<int> sms[kMaxDevices];
  int n = sms[device].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    sms[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

// 16-byte asynchronous copy to shared memory; with pred false the 16
// bytes are zero-filled (0 source bytes).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace fern
