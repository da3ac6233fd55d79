// One fp32 output tile of the port's GEMM with the fused epilogue:
// C = [res +] act(A . Bt^T + bias).
//
// Shared by gemm.cu, which gives each block one tile, and block.cu
// (kernel B10), whose persistent blocks walk every tile of a product in
// turn. Each .cu file compiles in its own nvcc process without
// relocatable device code, so the tiles live in headers as inline device
// functions rather than as kernels one file could call in another. The
// bf16 tiles run on the tensor cores in gemm_wgmma.cuh.
//
// Layouts: A [M, K] row-major (activations), Bt [N, K] row-major (the
// torch Linear / in_proj_weight layout, out x in), res [M, N], C [M, N]
// at row stride ldc >= N.
//
// SIMT FMA, 64 x 64 block tile, 4 x 4 outputs a thread, full fp32 (no
// TF32), over the K slice [kz0, kz1). The epilogue (common.cuh) applies
// bias, activation and the residual in registers, so the [M, N]
// pre-activation never reaches DRAM.
#pragma once

#include "common.cuh"

namespace fern {

constexpr int kThreads = 256;

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
