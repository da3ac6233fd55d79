// Kernel B4: the forward of the batch-based classification loss, one
// fp32 row loss per query,
//
//     row[i] = logsumexp_j(temp * p_i . t_j) - temp * p_i . t_i,
//
// for pred, tar [B, d] fp32 (contiguous) and row [B] fp32.
//
// Replaces: `_bbc_rowloss_pallas` (fashionern_aaai2024_tpu/ops/losses.py:55,
// kernel body `_bbc_fwd_kernel` at :33). Like the Pallas kernel it never
// writes the [B, B] logits to device memory: each block forms a tile of
// scores in registers and folds it into a running max and sum per row
// (the online log-sum-exp). The Pallas kernel padded B to 128 and d to
// 128 in device memory (:59-60) and masked the padded target columns
// (:44); here the ragged edges in B and d are masked inside the kernel
// and nothing is padded.
//
// Bound: operations. 2 B^2 d flops on CUDA cores in full fp32 (no TF32,
// so the scores keep fp32 accuracy before the x100 temperature), against
// (2 B d + B) x 4 bytes. At B = 1024, d = 512: 1.07 GFLOP and 4.2 MB, so
// about 16 us at the H100 SXM's 67 TFLOP/s fp32 rate (NVIDIA data sheet),
// far above the 1.3 us the bytes need at 3.35 TB/s.
//
// Design, first version (simple and right; not tuned):
//   * pass 1, `bbc_partial_kernel`: grid (row tiles of 64, column
//     splits). A block of 256 threads owns 64 query rows and a run of
//     64-wide column tiles of tar. Per column tile it streams 16-deep
//     slices of pred and tar through shared memory and each thread
//     accumulates a 4 x 4 micro-tile of scores with fp32 FMAs; the
//     scores then update the thread's running (max, sum) per row, and
//     the thread that holds the diagonal score writes it out. After the
//     last tile the 16 threads that share a row merge their (max, sum)
//     with shuffles and write one partial per (split, row).
//   * pass 2, `bbc_combine_kernel`: one thread per row merges the
//     splits' partials into the log-sum-exp and subtracts the diagonal.
//   Splitting the columns over blocks keeps the card busy at B = 1024,
//   where 64-row tiles alone would give 16 blocks for 132 SMs; the
//   split count comes from the wrapper (ops/losses.py), which allocates
//   the [splits, B] partials.

#include <math.h>

#include "common.cuh"

namespace fern {

constexpr int kBbcTile = 64;     // rows and columns of one score tile
constexpr int kBbcDepth = 16;    // d-slice staged in shared memory
constexpr int kBbcThreads = 256; // 16 x 16 threads, 4 x 4 scores each

// Merge the (max, sum-of-exp) pair (m2, l2) into (m, l).
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kBbcThreads)
bbc_partial_kernel(const float* __restrict__ pred, const float* __restrict__ tar,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ diag, int B, int d, float temp,
                   int tiles_per_split) {
  __shared__ float ps[kBbcDepth][kBbcTile + 1];
  __shared__ float ts[kBbcDepth][kBbcTile + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx + 16 j
  const int ty = tid / 16;  // row group: rows ty + 16 i
  const int row0 = blockIdx.x * kBbcTile;
  const int n_col_tiles = (B + kBbcTile - 1) / kBbcTile;
  const int ct_begin = blockIdx.y * tiles_per_split;
  const int ct_end = min(n_col_tiles, ct_begin + tiles_per_split);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int ct = ct_begin; ct < ct_end; ++ct) {
    const int col0 = ct * kBbcTile;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kBbcDepth) {
      // 64 x 16 elements of each operand, 4 per thread; consecutive
      // threads read consecutive k of one row
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * kBbcThreads;
        const int r = idx / kBbcDepth;
        const int k = idx % kBbcDepth;
        const int gk = k0 + k;
        const int pr = row0 + r;
        const int tc = col0 + r;
        ps[k][r] = (pr < B && gk < d) ? pred[(size_t)pr * d + gk] : 0.f;
        ts[k][r] = (tc < B && gk < d) ? tar[(size_t)tc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBbcDepth; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ps[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ts[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c >= B) continue;  // ragged edge: no target there
        const float s = temp * acc[i][j];
        if (r == c) diag[r] = s;
        lse_merge(m[i], l[i], s, 1.f);
      }
    }
  }

  // the 16 threads of one row group are 16 consecutive lanes of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o, 16);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], o, 16);
      lse_merge(m[i], l[i], m2, l2);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < B) {
      part_m[(size_t)blockIdx.y * B + r] = m[i];
      part_l[(size_t)blockIdx.y * B + r] = l[i];
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

// pred, tar [B, d] fp32; row [B] fp32; part_m, part_l [splits, B] and
// diag [B] fp32 scratch. Every split must own at least one column tile:
// splits == ceil(ceil(B / 64) / tiles_per_split).
extern "C" int fern_bbc_rowloss(const void* pred, const void* tar, void* row, void* part_m,
                                void* part_l, void* diag, int B, int d, float temp,
                                int splits, int tiles_per_split, int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  const int n_tiles = (B + fern::kBbcTile - 1) / fern::kBbcTile;
  if (d <= 0 || tiles_per_split <= 0 ||
      splits != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles, splits);
  fern::bbc_partial_kernel<<<grid, fern::kBbcThreads, 0, s>>>(
      static_cast<const float*>(pred), static_cast<const float*>(tar),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(diag),
      B, d, temp, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fern::bbc_combine_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(diag), static_cast<float*>(row), B, splits);
  return (int)cudaGetLastError();
}
