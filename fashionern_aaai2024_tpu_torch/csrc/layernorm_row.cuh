// One LayerNorm row, run by one warp: fp32 mean, then the two-pass
// variance (mean of squared deviations) as the Pallas kernels compute it,
// then y rounded to the storage type.
//
// Shared by layernorm.cu (kernel B11 and the LN launches of B1 / B2) and
// block.cu (kernel B10's two LNs). Each .cu file compiles in its own nvcc
// process, so the routine lives here as an inline device function.
#pragma once

#include "common.cuh"

namespace fern {

template <typename T>
__device__ __forceinline__ void layernorm_row(const T* __restrict__ xr,
                                              const T* __restrict__ g,
                                              const T* __restrict__ b, T* __restrict__ yr,
                                              int width, float eps, int lane) {
  float s = 0.f;
  for (int c = lane; c < width; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / width;
  float v = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / width + eps);
  for (int c = lane; c < width; c += 32) {
    const float d = to_f(xr[c]) - mean;
    yr[c] = from_f<T>(d * inv * to_f(g[c]) + to_f(b[c]));
  }
}

}  // namespace fern
