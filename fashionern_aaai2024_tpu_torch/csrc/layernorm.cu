// Row LayerNorm with fp32 statistics: kernel B11 (`layer_norm`) and the
// LN prologue of kernels B1 (attention sub-block) and B2 (MLP sub-block).
//
// Replaces: `_layer_norm_pallas` (fashionern_aaai2024_tpu/ops/layernorm.py:46,
// body `_ln_kernel` :27-34), and the LN at the head of `_subblock_kernel`
// (ops/attention.py:484-489) and of `_mlp_kernel` (ops/mlp.py:94-99). On
// the TPU the last two ran inside the sub-block program; here they are
// their own launch because the GEMM that follows tiles the rows
// differently.
//
// Bound: device-memory bandwidth at large row counts (it reads x once and
// writes y once: 2 x rows x W x sizeof(T)); at the query's 2-3 thousand
// rows a call moves a few MB and the launch's latency dominates.
// Design: one warp a row with the row in registers
// (`layernorm_row.cuh`, which kernel B10 runs too): one 16-byte load and
// one 16-byte store a vector, the two-pass statistics from the registers
// by warp shuffles (no shared memory, no block barrier), gamma and beta
// loaded once a warp. Each warp walks rows with a grid stride, and the
// grid holds as many blocks as the SMs keep resident at once (or fewer,
// one warp a row, when the rows are few). One kernel instance per
// vectors-a-lane count (1-8: W up to 1,024 fp32 / 2,048 bf16 in
// registers), sized by the compiler for it; any other width or alignment
// takes the general instance.

#include "layernorm_row.cuh"

namespace fern {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;

// VPL 0: the general routine.
template <typename T, int VPL>
__global__ void __launch_bounds__(kLnThreads)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                 T* __restrict__ y, int rows, int width, float eps) {
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int step = gridDim.x * kLnWarps;
  if constexpr (VPL > 0)
    layernorm_rows_vec<T, VPL>(x, g, b, y, rows, width, eps, warp, step, lane);
  else
    layernorm_rows_any(x, g, b, y, rows, width, eps, warp, step, lane);
}

template <typename T, int VPL>
static cudaError_t launch_instance(const void* x, const void* g, const void* b, void* y,
                                   int rows, int width, float eps, int device,
                                   cudaStream_t stream) {
  const int wanted = (rows + kLnWarps - 1) / kLnWarps;
  const int resident = max_resident_blocks<layernorm_kernel<T, VPL>>(device, kLnThreads);
  layernorm_kernel<T, VPL><<<wanted < resident ? wanted : resident, kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(y), rows, width, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_layernorm(const void* x, const void* g, const void* b, void* y,
                                    int rows, int width, float eps, int device,
                                    cudaStream_t stream) {
  switch (layernorm_vpl<T>(x, g, b, y, width)) {
#define FERN_LN_LAUNCH(VPL) \
  case VPL:                 \
    return launch_instance<T, VPL>(x, g, b, y, rows, width, eps, device, stream);
    FERN_LN_LAUNCH(1) FERN_LN_LAUNCH(2) FERN_LN_LAUNCH(3) FERN_LN_LAUNCH(4)
    FERN_LN_LAUNCH(5) FERN_LN_LAUNCH(6) FERN_LN_LAUNCH(7) FERN_LN_LAUNCH(8)
#undef FERN_LN_LAUNCH
    default:
      return launch_instance<T, 0>(x, g, b, y, rows, width, eps, device, stream);
  }
}

}  // namespace fern

// x, y: [rows, width] contiguous; g, b: [width]; all of type `dtype`.
extern "C" int fern_layernorm(const void* x, const void* g, const void* b, void* y,
                              int rows, int width, float eps, int dtype, int device,
                              void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (width < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16)
    return (int)fern::launch_layernorm<fern::bf16>(x, g, b, y, rows, width, eps, device, s);
  if (dtype == fern::DTYPE_F32)
    return (int)fern::launch_layernorm<float>(x, g, b, y, rows, width, eps, device, s);
  return (int)cudaErrorInvalidValue;
}
