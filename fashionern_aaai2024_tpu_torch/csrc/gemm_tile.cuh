// One output tile of the port's two GEMMs with the fused epilogue:
// C = [res +] cast(act(A . Bt^T + bias)).
//
// Shared by gemm.cu, which gives each block one tile, and block.cu
// (kernel B10), whose persistent blocks walk every tile of a product in
// turn. Each .cu file compiles in its own nvcc process without
// relocatable device code, so the tiles live here as inline device
// functions rather than as kernels one file could call in another.
//
// Layouts: A [M, K] row-major (activations), Bt [N, K] row-major (the
// torch Linear / in_proj_weight layout, out x in), res [M, N], C [M, N]
// at row stride ldc >= N.
//
// bf16: 128 x 128 block tile, 8 warps of 64 x 32, WMMA 16 x 16 x 16 bf16
// fragments with fp32 accumulators, and a two-stage cp.async pipeline so
// the next K tile loads while this one multiplies.
// fp32: SIMT FMA, 64 x 64 block tile, 4 x 4 outputs a thread, full fp32
// (no TF32), over the K slice [kz0, kz1).
// The epilogue (common.cuh) applies bias, activation, the cast and the
// residual in registers, so the [M, N] pre-activation never reaches DRAM.
// Both tiles end with a block barrier: the caller may reuse their shared
// memory (the next tile's loads, another phase's data) right after.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace fern {

namespace wmma = nvcuda::wmma;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // 80-byte rows: 32-byte aligned, staggered banks
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kThreads = 256;

// The bf16 tile's shared memory: A and B tiles, two stages each (40 KB).
struct Bf16TileSmem {
  bf16 As[2][kBM][kLds];
  bf16 Bs[2][kBN][kLds];
};

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

// The bf16 output tile at rows bm.., columns bn.. (a block of kThreads).
__device__ __forceinline__ void gemm_bf16_tile(Bf16TileSmem& sm, const bf16* __restrict__ A,
                                               const bf16* __restrict__ Bt,
                                               const bf16* __restrict__ bias,
                                               const bf16* __restrict__ res,
                                               bf16* __restrict__ C, int M, int N, int K,
                                               int ldc, int act, int bm, int bn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int kt_count = (K + kBK - 1) / kBK;
  load_tile(sm.As[0], A, bm, M, 0, K);
  load_tile(sm.Bs[0], Bt, bn, N, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_count) {
      load_tile(sm.As[buf ^ 1], A, bm, M, (kt + 1) * kBK, K);
      load_tile(sm.Bs[buf ^ 1], Bt, bn, N, (kt + 1) * kBK, K);
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
        wmma::load_matrix_sync(af[i], &sm.As[buf][wm * kWarpM + i * 16][kk], kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &sm.Bs[buf][wn * kWarpN + j * 16][kk], kLds);
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
  float* scr = reinterpret_cast<float*>(&sm.As[0][0][0]) + warp * 256;
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
        *reinterpret_cast<uint4*>(C + (size_t)gm * ldc + gn) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
  __syncthreads();  // the scratch is read before anyone refills the A tile
}

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

// The fp32 tile's shared memory (8.5 KB).
struct F32TileSmem {
  float As[kFBK][kFBM + 4];
  float Bs[kFBK][kFBN + 4];
};

// The fp32 output tile at rows bm.., columns bn.., summing over the K
// slice [kz0, kz1). Each thread owns a 4 x 4 block of C (rows 4ty..,
// columns 4tx..) and reads its four A values and four B values of a k
// step as one 16-byte shared load each (a warp's A loads are broadcasts
// of two addresses), so the FMAs, not shared-memory bandwidth, set the
// pace. The next K tile is fetched into registers while this one
// multiplies. Every output sums its products in k order, one fmaf at a
// time.
__device__ __forceinline__ void gemm_f32_tile(F32TileSmem& sm, const float* __restrict__ A,
                                              const float* __restrict__ Bt,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ res,
                                              float* __restrict__ C, int M, int N, int K,
                                              int ldc, int act, int bm, int bn, int kz0,
                                              int kz1) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 4, lk = (tid % 4) * 4;  // loader: row, first k of 4
  auto fetch = [&](int k0, float4& a, float4& b) {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
    if (bm + lr < M && k0 + lk < kz1)
      a = *reinterpret_cast<const float4*>(A + (size_t)(bm + lr) * K + k0 + lk);
    if (bn + lr < N && k0 + lk < kz1)
      b = *reinterpret_cast<const float4*>(Bt + (size_t)(bn + lr) * K + k0 + lk);
  };
  float acc[4][4] = {};
  float4 a, b;
  fetch(kz0, a, b);
  for (int k0 = kz0; k0 < kz1; k0 += kFBK) {
    sm.As[lk + 0][lr] = a.x; sm.As[lk + 1][lr] = a.y;
    sm.As[lk + 2][lr] = a.z; sm.As[lk + 3][lr] = a.w;
    sm.Bs[lk + 0][lr] = b.x; sm.Bs[lk + 1][lr] = b.y;
    sm.Bs[lk + 2][lr] = b.z; sm.Bs[lk + 3][lr] = b.w;
    __syncthreads();
    if (k0 + kFBK < kz1) fetch(k0 + kFBK, a, b);
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.As[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.Bs[k][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = bm + 4 * ty + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = bn + 4 * tx + j;
      if (gn >= N) continue;
      C[(size_t)gm * ldc + gn] =
          epilogue<float>(acc[i][j], bias, res, (size_t)gm * N + gn, gn, act);
    }
  }
}

}  // namespace fern
