// GEMM with a fused epilogue: C = [res +] cast(act(A . Bt^T + bias)).
//
// The four products inside kernels B1 and B2: the QKV projection and the
// out-projection + residual of `_subblock_kernel`
// (fashionern_aaai2024_tpu/ops/attention.py:491-515), and c_fc +
// activation and c_proj + residual of `_mlp_kernel` (ops/mlp.py:100-115).
//
// Layouts: A [M, K] row-major (activations), Bt [N, K] row-major (the
// torch Linear / in_proj_weight layout, out x in), C and res [M, N].
//
// Bound: at the serve shapes (M = B x 197 or B x 77, K and N in
// 512..3072) the products are compute-bound on the tensor cores: a
// 128 x 128 x 32 bf16 tile does 1 MFLOP per 16 KB loaded. The TPU kernel
// kept both weight matrices resident in 16+ MB of VMEM; 227 KB of shared
// memory cannot, so weights stream through shared memory tile by tile
// and the 50 MB L2 keeps them hot across the row blocks.
// Design (bf16): 128 x 128 block tile, 8 warps of 64 x 32, WMMA
// 16 x 16 x 16 bf16 fragments with fp32 accumulators, and a two-stage
// cp.async pipeline so the next K tile loads while this one multiplies.
// Design (fp32): SIMT FMA, 64 x 64 block tile, 4 x 4 outputs a thread,
// full fp32 (no TF32), as the fp32 parity tier needs.
// The epilogue (common.cuh) applies bias, activation, the cast and the
// residual in registers, so the [M, N] pre-activation never reaches DRAM.

#include <mma.h>

#include "common.cuh"

namespace fern {

namespace wmma = nvcuda::wmma;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // 80-byte rows: 32-byte aligned, staggered banks
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One 128 x 32 tile of a row-major [rows, K] matrix into shared memory.
__device__ __forceinline__ void load_tile(bf16 (*dst)[kLds], const bf16* src, int row0,
                                          int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;  // 512 chunks of 8 elements
    const int r = c / 4, kc = (c % 4) * 8;
    const bool ok = (row0 + r < rows) && (k0 + kc < K);
    const bf16* g = ok ? src + (size_t)(row0 + r) * K + k0 + kc : src;
    cp_async16(&dst[r][kc], g, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bt,
                 const bf16* __restrict__ bias, const bf16* __restrict__ res,
                 bf16* __restrict__ C, int M, int N, int K, int act) {
  __shared__ __align__(128) bf16 As[2][kBM][kLds];
  __shared__ __align__(128) bf16 Bs[2][kBN][kLds];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int kt_count = (K + kBK - 1) / kBK;
  load_tile(As[0], A, bm, M, 0, K);
  load_tile(Bs[0], Bt, bn, N, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_count) {
      load_tile(As[buf ^ 1], A, bm, M, (kt + 1) * kBK, K);
      load_tile(Bs[buf ^ 1], Bt, bn, N, (kt + 1) * kBK, K);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile kt has landed; tile kt+1 may be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[buf][wm * kWarpM + i * 16][kk], kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[buf][wn * kWarpN + j * 16][kk], kLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16 x 16 fp32 scratch in the (now idle)
  // A tile buffer: each lane finishes 8 consecutive columns of one row
  // and writes them as one 16-byte store.
  float* scr = reinterpret_cast<float*>(&As[0][0][0]) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = bm + wm * kWarpM + i * 16 + r;
      const int gn = bn + wn * kWarpN + j * 16 + c0;
      if (gm < M && gn < N) {  // N % 8 == 0: a chunk is wholly in or out
        const size_t idx = (size_t)gm * N + gn;
        __align__(16) bf16 out[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          out[t] = epilogue<bf16>(scr[r * 16 + c0 + t], bias, res, idx + t, gn + t, act);
        *reinterpret_cast<uint4*>(C + idx) = *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ Bt,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ C, int M, int N, int K, int act) {
  __shared__ float As[kFBK][kFBM + 4];
  __shared__ float Bs[kFBK][kFBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bm = blockIdx.y * kFBM, bn = blockIdx.x * kFBN;
  const int lr = tid / 4, lk = (tid % 4) * 4;  // loader: row, first k of 4
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFBK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (bm + lr < M && k0 + lk < K)
      a = *reinterpret_cast<const float4*>(A + (size_t)(bm + lr) * K + k0 + lk);
    if (bn + lr < N && k0 + lk < K)
      b = *reinterpret_cast<const float4*>(Bt + (size_t)(bn + lr) * K + k0 + lk);
    As[lk + 0][lr] = a.x; As[lk + 1][lr] = a.y; As[lk + 2][lr] = a.z; As[lk + 3][lr] = a.w;
    Bs[lk + 0][lr] = b.x; Bs[lk + 1][lr] = b.y; Bs[lk + 2][lr] = b.z; Bs[lk + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = bm + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = bn + tx + 16 * j;
      if (gn >= N) continue;
      const size_t idx = (size_t)gm * N + gn;
      C[idx] = epilogue<float>(acc[i][j], bias, res, idx, gn, act);
    }
  }
}

}  // namespace fern

extern "C" int fern_gemm(const void* a, const void* bt, const void* bias, const void* res,
                         void* c, int m, int n, int k, int act, int dtype, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16) {
    dim3 grid((n + fern::kBN - 1) / fern::kBN, (m + fern::kBM - 1) / fern::kBM);
    fern::gemm_bf16_kernel<<<grid, fern::kThreads, 0, s>>>(
        static_cast<const fern::bf16*>(a), static_cast<const fern::bf16*>(bt),
        static_cast<const fern::bf16*>(bias), static_cast<const fern::bf16*>(res),
        static_cast<fern::bf16*>(c), m, n, k, act);
    return (int)cudaGetLastError();
  }
  if (dtype == fern::DTYPE_F32) {
    dim3 grid((n + fern::kFBN - 1) / fern::kFBN, (m + fern::kFBM - 1) / fern::kFBM);
    fern::gemm_f32_kernel<<<grid, fern::kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(bt),
        static_cast<const float*>(bias), static_cast<const float*>(res),
        static_cast<float*>(c), m, n, k, act);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
