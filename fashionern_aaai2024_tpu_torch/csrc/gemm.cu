// GEMM with a fused epilogue: C = [res +] cast(act(A . Bt^T + bias)).
//
// The four products inside kernels B1 and B2: the QKV projection and the
// out-projection + residual of `_subblock_kernel`
// (fashionern_aaai2024_tpu/ops/attention.py:491-515), and c_fc +
// activation and c_proj + residual of `_mlp_kernel` (ops/mlp.py:100-115).
//
// Layouts: A [M, K] row-major (activations), Bt [N, K] row-major (the
// torch Linear / in_proj_weight layout, out x in), res [M, N], C [M, N]
// at row stride ldc >= N: kernel B12 writes its two projections straight
// into the two halves of one [M, 8d] concat buffer (ops/combiner.py).
//
// Bound: at the serve shapes (M = B x 197 or B x 77, K and N in
// 512..3072) the products are compute-bound on the tensor cores: a
// 128 x 128 x 32 bf16 tile does 1 MFLOP per 16 KB loaded. The TPU kernel
// kept both weight matrices resident in 16+ MB of VMEM; 227 KB of shared
// memory cannot, so weights stream through shared memory tile by tile
// and the 50 MB L2 keeps them hot across the row blocks.
// Design: one block per output tile of `gemm_tile.cuh` (bf16: WMMA
// 128 x 128 tiles behind a two-stage cp.async pipeline; fp32: SIMT FMA
// 64 x 64 tiles, full fp32, as the fp32 parity tier needs). A split-K
// entry (`fern_gemm_f32_partials`) writes one fp32 partial product per
// slice of K for kernel B12's hidden layer, where a few row tiles against
// a deep K would leave most SMs idle or waiting on memory.

#include "gemm_tile.cuh"

namespace fern {

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bt,
                 const bf16* __restrict__ bias, const bf16* __restrict__ res,
                 bf16* __restrict__ C, int M, int N, int K, int ldc, int act) {
  __shared__ __align__(128) Bf16TileSmem sm;
  gemm_bf16_tile(sm, A, Bt, bias, res, C, M, N, K, ldc, act, blockIdx.y * kBM,
                 blockIdx.x * kBN);
}

// blockIdx.z takes K slice [kz0, kz1) and writes its own [M, ldc] C.
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ Bt,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ C, int M, int N, int K, int ldc, int act, int k_per) {
  __shared__ __align__(16) F32TileSmem sm;
  const int kz0 = blockIdx.z * k_per, kz1 = min(K, kz0 + k_per);
  gemm_f32_tile(sm, A, Bt, bias, res, C + (size_t)blockIdx.z * M * ldc, M, N, K, ldc, act,
                blockIdx.y * kFBM, blockIdx.x * kFBN, kz0, kz1);
}

}  // namespace fern

// ldc: C's row stride in elements (n for a contiguous C; a multiple of
// 8 in bf16, for the 16-byte stores).
extern "C" int fern_gemm(const void* a, const void* bt, const void* bias, const void* res,
                         void* c, int m, int n, int k, int ldc, int act, int dtype,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ldc < n) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16) {
    dim3 grid((n + fern::kBN - 1) / fern::kBN, (m + fern::kBM - 1) / fern::kBM);
    fern::gemm_bf16_kernel<<<grid, fern::kThreads, 0, s>>>(
        static_cast<const fern::bf16*>(a), static_cast<const fern::bf16*>(bt),
        static_cast<const fern::bf16*>(bias), static_cast<const fern::bf16*>(res),
        static_cast<fern::bf16*>(c), m, n, k, ldc, act);
    return (int)cudaGetLastError();
  }
  if (dtype == fern::DTYPE_F32) {
    dim3 grid((n + fern::kFBN - 1) / fern::kFBN, (m + fern::kFBM - 1) / fern::kFBM);
    fern::gemm_f32_kernel<<<grid, fern::kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(bt),
        static_cast<const float*>(bias), static_cast<const float*>(res),
        static_cast<float*>(c), m, n, k, ldc, act, k);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// fp32 split-K product without epilogue: partials [ceil(k / k_per), m, n],
// slice z = a[:, z*k_per : (z+1)*k_per] . bt[:, same]^T. k_per: a
// multiple of 16 (the k tile).
extern "C" int fern_gemm_f32_partials(const void* a, const void* bt, void* partials, int m,
                                      int n, int k, int k_per, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k_per < fern::kFBK || k_per % fern::kFBK) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  dim3 grid((n + fern::kFBN - 1) / fern::kFBN, (m + fern::kFBM - 1) / fern::kFBM,
            (k + k_per - 1) / k_per);
  fern::gemm_f32_kernel<<<grid, fern::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(bt), nullptr, nullptr,
      static_cast<float*>(partials), m, n, k, n, fern::ACT_NONE, k_per);
  return (int)cudaGetLastError();
}
