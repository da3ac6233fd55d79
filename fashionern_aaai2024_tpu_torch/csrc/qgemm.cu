// int8 GEMM with a rescaling epilogue: the four int8 products of kernels
// B5 and B6.
//
// Replaces: the `dot_general(..., preferred_element_type=int32)` calls
// and the fp32 rescales of `_qmlp_kernel` (fashionern_aaai2024_tpu/ops/
// qmlp.py:65-77) and `_qattn_kernel` (`qmlp.py:179-184, 203-208`).
//
//   C[m, n] = epi( float(A[m, :] . Bt[n, :]) * a_scale[m] * b_scale[n] )
//
// A int8 [M, K] with row stride lda, Bt int8 [N, K] with row stride ldb
// (the torch Linear layout, out x in; a column group of B5's second
// product is a pointer offset and the full row stride), int32
// accumulation on the tensor cores, K a multiple of 16. The epilogue, in
// the Pallas kernels' order, each step rounded on its own (`__fmul_rn`,
// `__fadd_rn`; no FMA contraction): the int32 sum converted once
// (`__int2float_rn`), times the row scale, times the column scale; then
// `partial[m, n] +` (B5's fp32 sum over hidden groups, `qmlp.py:77`);
// `+ bias[n]`; the activation; then stored fp32, or cast to the storage
// type T, and `res[m, n] +` in T (`x + proj.astype(x.dtype)`).
//
// Bound: at the serve shapes the products are compute-bound on the int8
// tensor cores (1,979 TOPS dense on an H100 SXM): a 128 x 128 x 64 tile
// does 2 MOPS per 16 KB loaded. Int8 weights (4.7 MB at W = 768) do not
// fit in 227 KB of shared memory as the TPU kernel kept them in VMEM:
// they stream through shared memory tile by tile and stay hot in the
// 50 MB L2.
// Design: the tile and cp.async pattern of gemm.cu: a 128 x 128 block
// tile, 8 warps of 64 x 32, WMMA `signed char` 16 x 16 x 16 fragments
// with `int` accumulators (IMMA on Hopper), two stages so the next K tile
// loads while this one multiplies. Shared tiles are stored as [K / 16]
// slabs of [128 rows][16 bytes]: every fragment pointer is 256-bit
// aligned and a fragment is 256 contiguous bytes, free of bank conflicts.

#include <mma.h>

#include "common.cuh"

namespace fern {

namespace wmma = nvcuda::wmma;

constexpr int kQBM = 128, kQBN = 128, kQBK = 64;
constexpr int kQSlabs = kQBK / 16;
constexpr int kQWarpM = 64, kQWarpN = 32;
constexpr int kQThreads = 256;

using i8 = signed char;

// One 128 x 64 tile of an int8 [rows, K] matrix (row stride ld) into
// shared memory as four [128][16] slabs.
__device__ __forceinline__ void load_qtile(i8 (*dst)[kQBM][16], const i8* src, size_t ld,
                                           int row0, int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kQThreads;  // 512 chunks of 16 bytes
    const int r = c / kQSlabs, s = c % kQSlabs;
    const bool ok = (row0 + r < rows) && (k0 + s * 16 < K);
    const i8* g = ok ? src + (size_t)(row0 + r) * ld + k0 + s * 16 : src;
    cp_async16(&dst[s][r][0], g, ok);
  }
}

// Up to 8 consecutive elements as fp32; one or two 16-byte accesses when
// `vec` (8 elements, 16-byte aligned).
__device__ __forceinline__ void load8(const float* src, float* v, int n, bool vec) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
  for (int t = 0; t < n; ++t) v[t] = src[t];
}
__device__ __forceinline__ void load8(const bf16* src, float* v, int n, bool vec) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = to_f(h[t]);
    return;
  }
  for (int t = 0; t < n; ++t) v[t] = to_f(src[t]);
}
__device__ __forceinline__ void store8(float* dst, const float* v, int n, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  for (int t = 0; t < n; ++t) dst[t] = v[t];
}
__device__ __forceinline__ void store8(bf16* dst, const float* v, int n, bool vec) {
  if (vec) {
    __align__(16) bf16 h[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) h[t] = from_f<bf16>(v[t]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
    return;
  }
  for (int t = 0; t < n; ++t) dst[t] = from_f<bf16>(v[t]);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kQThreads)
qgemm_kernel(const i8* __restrict__ A, int lda, const i8* __restrict__ Bt, int ldb,
             const float* __restrict__ a_scale, int a_scale_stride,
             const float* __restrict__ b_scale, const T* __restrict__ bias,
             const float* __restrict__ partial, const T* __restrict__ res,
             TO* __restrict__ C, int M, int N, int K, int act) {
  __shared__ __align__(128) i8 As[2][kQSlabs][kQBM][16];
  __shared__ __align__(128) i8 Bs[2][kQSlabs][kQBN][16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int bm = blockIdx.y * kQBM, bn = blockIdx.x * kQBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int kt_count = (K + kQBK - 1) / kQBK;
  load_qtile(As[0], A, lda, bm, M, 0, K);
  load_qtile(Bs[0], Bt, ldb, bn, N, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_count) {
      load_qtile(As[buf ^ 1], A, lda, bm, M, (kt + 1) * kQBK, K);
      load_qtile(Bs[buf ^ 1], Bt, ldb, bn, N, (kt + 1) * kQBK, K);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile kt has landed; tile kt+1 may be in flight
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kQSlabs; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, i8, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, i8, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[buf][s][wm * kQWarpM + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[buf][s][wn * kQWarpN + j * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16 x 16 int32 scratch in the (now idle)
  // A tile buffer: each lane finishes 8 consecutive columns of one row,
  // read and written as 16-byte vectors where N % 8 == 0 and the
  // pointers are 16-byte aligned.
  int* scr = reinterpret_cast<int*>(&As[0][0][0][0]) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
  const bool aligned = N % 8 == 0 && ((reinterpret_cast<size_t>(C) |
                                       reinterpret_cast<size_t>(res) |
                                       reinterpret_cast<size_t>(partial)) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = bm + wm * kQWarpM + i * 16 + r;
      const int gn = bn + wn * kQWarpN + j * 16 + c0;
      if (gm < M && gn < N) {
        const int cols = min(8, N - gn);
        const bool vec = cols == 8 && aligned;
        const size_t idx = (size_t)gm * N + gn;
        const float as = a_scale[(size_t)gm * a_scale_stride];
        float v[8], p[8], rs[8];
        if (partial != nullptr) load8(partial + idx, p, cols, vec);
        if (res != nullptr) load8(res + idx, rs, cols, vec);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (t >= cols) break;
          const float acc32 = __int2float_rn(scr[r * 16 + c0 + t]);
          v[t] = __fmul_rn(__fmul_rn(acc32, as), b_scale[gn + t]);
          if (partial != nullptr) v[t] = __fadd_rn(p[t], v[t]);
          if (bias != nullptr) v[t] = __fadd_rn(v[t], to_f(bias[gn + t]));
          v[t] = apply_act(v[t], act);
          if (res != nullptr) v[t] = __fadd_rn(rs[t], round_to<TO>(v[t]));
        }
        store8(C + idx, v, cols, vec);
      }
      __syncwarp();
    }
  }
}

template <typename T, typename TO>
static cudaError_t launch_qgemm(const void* a, int lda, const void* bt, int ldb,
                                const void* a_scale, int a_scale_stride, const void* b_scale,
                                const void* bias, const void* partial, const void* res,
                                void* c, int m, int n, int k, int act, cudaStream_t stream) {
  dim3 grid((n + kQBN - 1) / kQBN, (m + kQBM - 1) / kQBM);
  qgemm_kernel<T, TO><<<grid, kQThreads, 0, stream>>>(
      static_cast<const i8*>(a), lda, static_cast<const i8*>(bt), ldb,
      static_cast<const float*>(a_scale), a_scale_stride, static_cast<const float*>(b_scale),
      static_cast<const T*>(bias), static_cast<const float*>(partial),
      static_cast<const T*>(res), static_cast<TO*>(c), m, n, k, act);
  return cudaGetLastError();
}

}  // namespace fern

// dtype: the type of bias and res; out_f32: C is fp32 rather than dtype
// (with bf16 bias, res must then be null). partial, when given, is fp32
// [m, n].
extern "C" int fern_qgemm(const void* a, int lda, const void* bt, int ldb, const void* a_scale,
                          int a_scale_stride, const void* b_scale, const void* bias,
                          const void* partial, const void* res, void* c, int m, int n, int k,
                          int act, int dtype, int out_f32, int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (k % 16 || lda % 16 || ldb % 16 ||
      (out_f32 && dtype == fern::DTYPE_BF16 && res != nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using fern::bf16;
  using fern::launch_qgemm;
  if (dtype == fern::DTYPE_BF16 && out_f32)
    return (int)launch_qgemm<bf16, float>(a, lda, bt, ldb, a_scale, a_scale_stride, b_scale,
                                          bias, partial, res, c, m, n, k, act, s);
  if (dtype == fern::DTYPE_BF16)
    return (int)launch_qgemm<bf16, bf16>(a, lda, bt, ldb, a_scale, a_scale_stride, b_scale,
                                         bias, partial, res, c, m, n, k, act, s);
  if (dtype == fern::DTYPE_F32)
    return (int)launch_qgemm<float, float>(a, lda, bt, ldb, a_scale, a_scale_stride, b_scale,
                                           bias, partial, res, c, m, n, k, act, s);
  return (int)cudaErrorInvalidValue;
}
