// Row LayerNorm with fp32 statistics: the LN prologue of kernels B1
// (attention sub-block) and B2 (MLP sub-block).
//
// Replaces: the LN at the head of `_subblock_kernel`
// (fashionern_aaai2024_tpu/ops/attention.py:484-489) and of `_mlp_kernel`
// (ops/mlp.py:94-99). On the TPU it ran inside the sub-block program;
// here it is its own launch because the GEMM that follows tiles the rows
// differently.
//
// Bound: device-memory bandwidth. It reads x once from DRAM (the second
// and third passes hit L1) and writes y once: 2 x rows x W x sizeof(T).
// Design: one warp per row (`layernorm_row.cuh`, which kernel B10 runs
// too), so the mean and variance reductions are warp shuffles with no
// shared memory and no block barrier. Two-pass variance (mean of squared
// deviations), as the Pallas kernel computes it; y is rounded to the
// storage type before the GEMM reads it.

#include "layernorm_row.cuh"

namespace fern {

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                 const T* __restrict__ b, T* __restrict__ y,
                                 int rows, int width, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= rows) return;
  layernorm_row(x + (size_t)row * width, g, b, y + (size_t)row * width, width, eps,
                threadIdx.x % 32);
}

template <typename T>
static cudaError_t launch_layernorm(const void* x, const void* g, const void* b, void* y,
                                    int rows, int width, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int rows_per_block = kThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  layernorm_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(y), rows, width, eps);
  return cudaGetLastError();
}

}  // namespace fern

extern "C" int fern_layernorm(const void* x, const void* g, const void* b, void* y,
                              int rows, int width, float eps, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16)
    return (int)fern::launch_layernorm<fern::bf16>(x, g, b, y, rows, width, eps, s);
  if (dtype == fern::DTYPE_F32)
    return (int)fern::launch_layernorm<float>(x, g, b, y, rows, width, eps, s);
  return (int)cudaErrorInvalidValue;
}
