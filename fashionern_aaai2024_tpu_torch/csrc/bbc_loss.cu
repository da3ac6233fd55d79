// Kernel B4: the forward of the batch-based classification loss, one
// fp32 row loss per query,
//
//     row[i] = logsumexp_j(temp * p_i . t_j) - temp * p_i . t_(offset + i),
//
// for pred [B, d] and tar [N, d] fp32 (contiguous, d % 4 == 0, 16-byte
// aligned: the wrapper pads and copies where they are not), N >= offset + B,
// and row [B] fp32. With N = B and offset = 0 it is the loss over local
// negatives (the positive on the diagonal); the global negatives of a
// data-parallel step pass the all-gathered targets [size * B, d] and
// offset = rank * B (JAX `ops/losses.py:120-139`, which computes the same
// function with XLA's matmul and logsumexp).
//
// Replaces: `_bbc_rowloss_pallas` (fashionern_aaai2024_tpu/ops/losses.py:55,
// kernel body `_bbc_fwd_kernel` at :33). Like the Pallas kernel it never
// writes the [B, B] logits to device memory: each block forms tiles of
// scores in registers and folds each into a running max and sum per row
// (the online log-sum-exp). The Pallas kernel padded B to 128 and d to
// 128 in device memory (:59-60) and masked the padded target columns
// (:44); here TMA zero-fills rows and columns past the matrices, and the
// columns past N are masked to -inf in the epilogue (a zero-filled column
// would enter the sum as a score of 0).
//
// Bound: operations. 2 B N d flops at fp32 accuracy: three TF32 passes
// on the tensor cores (6 B N d at 495 TFLOP/s: 6.5 us at B = N = 1024,
// d = 512), against (B d + N d + B) x 4 bytes (4.2 MB, 1.3 us at 3.35 TB/s).
// Scores are multiplied by temp = 100 before the exponential, so one tf32
// pass (about three decimal digits) would not hold the fp32 tolerance.
// Design: the 3xTF32 body of `gemm_tf32.cuh` on the TMA ring, pred rows
// as A (split in registers), tar rows as B (split into shared memory),
// the reduction over d.
//   * pass 1, `bbc_partial_kernel`: grid (row tiles of 128, column
//     splits). A block of 256 threads (two warpgroups of 64 rows) owns
//     128 query rows and a run of 64-wide column tiles of tar; the
//     (pred, tar) K tiles of every column tile stream in turn through a
//     five-stage TMA ring. Per column tile the block forms the 128 x 64
//     scores (`tf32_ktiles`), then, in registers: multiply by temp, mask columns >= N to -inf, take
//     each row's tile max across the four lanes that share a row of the
//     m64n64k8 fragment (two shuffles), one exponential a score against
//     that max, and merge the tile's (max, sum) into the row's running
//     pair once a tile (the four lanes hold the same max, each its own
//     part of the sum); the thread that holds a row's positive score
//     (column offset + row) writes it out. After the last tile the four lanes add their sums and write one
//     partial per (split, row).
//   * pass 2, `bbc_combine_kernel`: one thread per row merges the
//     splits' partials into the log-sum-exp and subtracts the diagonal.
//   Splitting the columns over blocks keeps the card busy at B = 1024,
//   where 128-row tiles alone would give 8 blocks for 132 SMs; the
//   split count comes from the wrapper (ops/losses.py `split_plan`),
//   which allocates the [splits, B] partials.

#include <math.h>

#include <mutex>

#include "gemm_tf32.cuh"
#include "tma.cuh"

namespace fern {

constexpr int kBbcBN = 64;  // columns of one score tile
using BbcRing = TfRing<kBbcBN, kTfStages>;

// Merge the (max, sum-of-exp) pair (m2, l2) into (m, l).
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kTfThreads, 1)
bbc_partial_kernel(const __grid_constant__ CUtensorMap map_p,
                   const __grid_constant__ CUtensorMap map_t, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ diag, int B, int N,
                   int d, int offset, float temp, int tiles_per_split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* operands = smem + BbcRing::kRing;
  const uint32_t full = smem_addr(operands + 2 * BbcRing::kOperandBytes);
  const int row0 = blockIdx.x * kTfBM;
  const int n_col_tiles = (N + kBbcBN - 1) / kBbcBN;
  const int ct_begin = blockIdx.y * tiles_per_split;
  const int ct_end = min(n_col_tiles, ct_begin + tiles_per_split);
  const int kt_count = (d + kTfBK - 1) / kTfBK;
  const int total = (ct_end - ct_begin) * kt_count;
  // K tile j of the block: d-slice j % kt_count of column tile j / kt_count
  const auto load = [&](int j, uint32_t dst, uint32_t bar) {
    const int kt = j % kt_count, ct = ct_begin + j / kt_count;
    tma_load(&map_p, dst, bar, kt * kTfBK, row0);
    tma_load(&map_t, dst + kTfTileABytes, bar, kt * kTfBK, ct * kBbcBN);
  };
  tf32_ring_start<kBbcBN, kTfStages>(total, smem, full, load);

  // this thread's rows r and r + 8 of the m64n64k8 fragment, and its
  // columns 8j + 2(t%4) and the next of each n8 block j
  const int t = threadIdx.x % 128;
  const int r = row0 + (threadIdx.x / 128) * kWgRows + 16 * (t / 32) + (t % 32) / 4;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int ct = ct_begin; ct < ct_end; ++ct) {
    float acc[kBbcBN / 2];
    tf32_ktiles<kBbcBN, kTfStages, true>(acc, (ct - ct_begin) * kt_count, kt_count, total, smem,
                                    operands, full, load);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      float s[kBbcBN / 4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBbcBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = ct * kBbcBN + 8 * j + 2 * (t % 4) + e;
          const float v = col < N ? temp * acc[4 * j + 2 * h + e] : -INFINITY;
          if (col == row + offset && row < B) diag[row] = v;
          s[2 * j + e] = v;
          mt = fmaxf(mt, v);
        }
      // the tile's row max: the four lanes of a row are l, l^1, l^2, l^3
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      float lt = 0.f;
#pragma unroll
      for (int e = 0; e < kBbcBN / 4; ++e) lt += expf(s[e] - mt);
      lse_merge(m[h], l[h], mt, lt);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r + 8 * h;
    if (t % 4 == 0 && row < B) {
      part_m[(size_t)blockIdx.y * B + row] = m[h];
      part_l[(size_t)blockIdx.y * B + row] = l[h];
    }
  }
}

__global__ void bbc_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ diag, float* __restrict__ row,
                                   int B, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float m = -INFINITY, l = 0.f;
  for (int s = 0; s < splits; ++s) lse_merge(m, l, part_m[(size_t)s * B + r],
                                             part_l[(size_t)s * B + r]);
  row[r] = m + logf(l) - diag[r];
}

}  // namespace fern

// pred [B, d], tar [N, d] fp32 at 16-byte aligned addresses, d % 4 == 0
// (TMA's rules), 0 <= offset, offset + B <= N; row [B] fp32; part_m,
// part_l [splits, B] and diag [B] fp32 scratch. Every split must own at
// least one 64-wide column tile: splits == ceil(ceil(N / 64) /
// tiles_per_split).
extern "C" int fern_bbc_rowloss(const void* pred, const void* tar, void* row, void* part_m,
                                void* part_l, void* diag, int B, int d, float temp,
                                int splits, int tiles_per_split, int N, int offset,
                                int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  if (offset < 0 || N < offset + B) return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + fern::kBbcBN - 1) / fern::kBbcBN;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(pred) | reinterpret_cast<unsigned long long>(tar);
  if (d <= 0 || d % 4 || addr % 16 || tiles_per_split <= 0 ||
      splits != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  static std::mutex mu;
  static bool opted[fern::kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted[device]) {
      err = cudaFuncSetAttribute(fern::bbc_partial_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)fern::BbcRing::kSmem);
      if (err != cudaSuccess) return (int)err;
      opted[device] = true;
    }
  }
  CUtensorMap map_p, map_t;
  err = fern::tile_map(&map_p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), pred, B, d,
                       fern::kTfBK, fern::kTfBM);
  if (err != cudaSuccess) return (int)err;
  err = fern::tile_map(&map_t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), tar, N, d,
                       fern::kTfBK, fern::kBbcBN);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + fern::kTfBM - 1) / fern::kTfBM, splits);
  fern::bbc_partial_kernel<<<grid, fern::kTfThreads, fern::BbcRing::kSmem, s>>>(
      map_p, map_t, static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(diag), B, N, d, offset, temp, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fern::bbc_combine_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(diag), static_cast<float*>(row), B, splits);
  return (int)cudaGetLastError();
}
