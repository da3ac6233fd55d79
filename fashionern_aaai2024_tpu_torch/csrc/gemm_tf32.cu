// The port's fp32 GEMM on the tensor cores, at fp32 accuracy (3xTF32 on
// warpgroup MMA, `gemm_tf32.cuh`), fed by a TMA ring:
//
//     C[:, p*N : (p+1)*N] = [res +] act(A_p . B_p^T + bias_p),  p < problems (1 or 2)
//
// or, split over K, one fp32 partial product per K slice (no bias, no
// activation, no residual; kernel B12's row kernel in combiner.cu sums
// them).
//
// Replaces, in fp32: the four products inside kernels B1 and B2 (the QKV
// projection and out-projection + residual of `_subblock_kernel`,
// fashionern_aaai2024_tpu/ops/attention.py:491-515; c_fc + activation and
// c_proj + residual of `_mlp_kernel`, ops/mlp.py:100-115), the QKV
// projection of B7 (`_qkv_fused_kernel`, ops/attention.py:361-384; the
// DVR mini-BERT, fp32 on every query), and the three products of B12
// (`_combiner_kernel` / `_combiner_pallas`, ops/combiner.py:35-59, 63):
// the two ReLU projections in one launch (problems = 2, each writing its
// half of the [M, 8d] concat buffer) and the hidden layer [M, 8d] x
// [8d, 8d]^T. On the TPU an fp32 product at the highest precision is
// itself a multi-pass product in a narrower type; here it is 3xTF32.
//
// Layouts: A [M, K] and B [N, K] row-major (the activations and the torch
// Linear weight); res [M, N] contiguous; C at row stride ldc. K % 4 == 0
// and 16-byte aligned A and B (TMA's rules); N % 8 == 0.
//
// Bound: at B7's b = 32 (M = 2,912, K = 640, N = 1,920) three passes of
// 7.16 GFLOP on the tensor cores (0.043 ms at 495 TFLOP/s); at B12's
// M <= 128 the weights' bytes (W_h is 64 MB at d = 512); at B7's b = 1
// (M = 91) neither: one K tile after another (20 at K = 640), each a
// pipeline step of the ring, on as many SMs as there are tiles.
// Design: a block of 256 threads takes a 128 x BN output tile (BN = 128,
// or 64 or 32 where the narrower tiles take less time in their waves, by
// the wrapper's rule, `ops/common.py f32_tile`): a ring of five stages of
// (A, B) 32-deep K tiles (128 bytes a row, the 128-byte swizzle), each
// with an mbarrier, that thread 0 refills by TMA as soon as every thread
// has read a stage; the two warpgroups (64 rows each) run `tf32_ktiles`
// on them (B split into one of
// two operand buffers, A split in registers, one K tile's wgmmas in
// flight; for every product but B12's, each K tile's partial folded into
// the accumulator on the CUDA cores) and the epilogue from registers (`tf32_epilogue`: bias,
// activation, residual, float2 stores at ldc). The activation is a
// compile-time constant of each instance. Every warpgroup issues its
// wgmmas, also where its 64 rows all lie past M (zeros from TMA's fill):
// a branch around them would make ptxas serialize every wgmma of the
// kernel. The split costs no device memory: the weights stay as they are.

#include <mutex>

#include "gemm_tf32.cuh"
#include "tma.cuh"

namespace fern {

// The output tile at rows blockIdx.y * 128.., columns (blockIdx.x % tiles
// of N) * BN.. of problem blockIdx.x / (tiles of N), over the K tiles of
// slice blockIdx.z (k_per elements each).
template <int BN, int ACT, bool FOLD>
__global__ void __launch_bounds__(kTfThreads, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_a0,
                 const __grid_constant__ CUtensorMap map_b0,
                 const __grid_constant__ CUtensorMap map_a1,
                 const __grid_constant__ CUtensorMap map_b1, const float* __restrict__ bias0,
                 const float* __restrict__ bias1, const float* __restrict__ res,
                 float* __restrict__ C, int M, int N, int K, int ldc, int k_per) {
  using Ring = TfRing<BN, kTfStages>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* operands = smem + Ring::kRing;  // two operand buffers
  const uint32_t full = smem_addr(operands + 2 * Ring::kOperandBytes);
  const int n_tiles = (N + BN - 1) / BN;
  const int problem = blockIdx.x / n_tiles;
  const int bm = blockIdx.y * kTfBM, bn = (blockIdx.x % n_tiles) * BN;
  const int k0 = blockIdx.z * k_per;
  const int k1 = min(K, k0 + k_per);
  const int kt_count = k1 > k0 ? (k1 - k0 + kTfBK - 1) / kTfBK : 0;
  const CUtensorMap* map_a = problem ? &map_a1 : &map_a0;
  const CUtensorMap* map_b = problem ? &map_b1 : &map_b0;
  const auto load = [&](int j, uint32_t dst, uint32_t bar) {
    tma_load(map_a, dst, bar, k0 + j * kTfBK, bm);
    tma_load(map_b, dst + kTfTileABytes, bar, k0 + j * kTfBK, bn);
  };
  tf32_ring_start<BN, kTfStages>(kt_count, smem, full, load);
  float acc[BN / 2];
  tf32_ktiles<BN, kTfStages, FOLD>(acc, 0, kt_count, kt_count, smem, operands, full, load);
  tf32_epilogue<BN, ACT>(acc, problem ? bias1 : bias0, res,
                         C + (size_t)blockIdx.z * M * ldc + (size_t)problem * N, M, N, ldc,
                         bm + (threadIdx.x / 128) * kWgRows, bn, threadIdx.x % 128);
}

template <int BN, int ACT, bool FOLD>
static cudaError_t launch_tf32(const void* const* ops, const float* bias0, const float* bias1,
                               const float* res, float* c, int problems, int m, int n, int k,
                               int ldc, int k_per, int device, cudaStream_t stream) {
  using Ring = TfRing<BN, kTfStages>;
  static std::mutex mu;
  static bool opted[kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(gemm_tf32_kernel<BN, ACT, FOLD>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)Ring::kSmem);
      if (err != cudaSuccess) return err;
      opted[device] = true;
    }
  }
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    if (i >= 2 && problems == 1) {
      maps[i] = maps[i - 2];
      continue;
    }
    const bool b = i % 2;
    const cudaError_t err = tile_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float),
                                     ops[i], b ? n : m, k, kTfBK, b ? BN : kTfBM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(problems * ((n + BN - 1) / BN), (m + kTfBM - 1) / kTfBM,
                  (k + k_per - 1) / k_per);
  gemm_tf32_kernel<BN, ACT, FOLD><<<grid, kTfThreads, Ring::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias0, bias1, res, c, m, n, k, ldc, k_per);
  return cudaGetLastError();
}

template <int BN>
static cudaError_t launch_tf32_act(int act, const void* const* ops, const float* bias0,
                                   const float* bias1, const float* res, float* c,
                                   int problems, int m, int n, int k, int ldc, int k_per,
                                   int device, cudaStream_t stream) {
  switch (act) {
    case ACT_QUICK_GELU:
      return launch_tf32<BN, ACT_QUICK_GELU, true>(ops, bias0, bias1, res, c, problems, m, n, k,
                                                   ldc, k_per, device, stream);
    case ACT_GELU:
      return launch_tf32<BN, ACT_GELU, true>(ops, bias0, bias1, res, c, problems, m, n, k, ldc,
                                             k_per, device, stream);
    case ACT_RELU:
      return launch_tf32<BN, ACT_RELU, true>(ops, bias0, bias1, res, c, problems, m, n, k, ldc,
                                             k_per, device, stream);
    default:
      return launch_tf32<BN, ACT_NONE, true>(ops, bias0, bias1, res, c, problems, m, n, k, ldc,
                                             k_per, device, stream);
  }
}

}  // namespace fern

// problems = 1 or 2: problem p computes C[:, p*n : (p+1)*n] = [res +]
// act(a_p . b_p^T + bias_p) for a_p [m, k], b_p [n, k] (a1, b1, bias1
// unused when problems = 1; res [m, n] contiguous, problems = 1 only).
// k_per: the K slice of a grid layer, a multiple of 32; with k_per < k
// (one problem, no bias, activation or residual) slice z writes its
// partial product to C + z * m * ldc. C 8-byte aligned at an even row
// stride ldc; bias_p and res may be null; act: an `Act` code; tile: the
// output tile's width, 32, 64 or 128; fold: 1 to add each K tile's
// partial into the sum on the CUDA cores (fp32 accuracy at any depth), 0
// for kernel B12's products (tile 128, no residual, ReLU or none: every
// wgmma adds into the sum). All fp32.
extern "C" int fern_gemm_tf32(const void* a0, const void* b0, const void* bias0,
                              const void* a1, const void* b1, const void* bias1,
                              const void* res, void* c, int problems, int m, int n, int k,
                              int ldc, int act, int k_per, int tile, int fold, int device,
                              void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const bool split = k_per < k;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(a0) | reinterpret_cast<unsigned long long>(b0) |
      (problems == 2 ? reinterpret_cast<unsigned long long>(a1) |
                           reinterpret_cast<unsigned long long>(b1)
                     : 0ULL);
  if (problems < 1 || problems > 2 || addr % 16 || reinterpret_cast<uintptr_t>(c) % 8 ||
      k % 4 || n % 8 || ldc % 2 || ldc < problems * n || k_per < fern::kTfBK ||
      k_per % fern::kTfBK || act < fern::ACT_NONE || act > fern::ACT_RELU ||
      (tile != 32 && tile != 64 && tile != 128) || (res != nullptr && problems != 1) ||
      (split && (problems != 1 || bias0 != nullptr || act != fern::ACT_NONE || res != nullptr)) ||
      (!fold && (tile != 128 || res != nullptr ||
                 (act != fern::ACT_NONE && act != fern::ACT_RELU))))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const void* ops[4] = {a0, b0, problems == 2 ? a1 : a0, problems == 2 ? b1 : b0};
  const float *f0 = static_cast<const float*>(bias0), *f1 = static_cast<const float*>(bias1);
  const float* r = static_cast<const float*>(res);
  float* out = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fold)
    return act == fern::ACT_RELU
               ? (int)fern::launch_tf32<128, fern::ACT_RELU, false>(ops, f0, f1, r, out, problems,
                                                                    m, n, k, ldc, k_per, device, s)
               : (int)fern::launch_tf32<128, fern::ACT_NONE, false>(ops, f0, f1, r, out, problems,
                                                                    m, n, k, ldc, k_per, device, s);
  if (tile == 32)
    return (int)fern::launch_tf32_act<32>(act, ops, f0, f1, r, out, problems, m, n, k, ldc,
                                          k_per, device, s);
  if (tile == 64)
    return (int)fern::launch_tf32_act<64>(act, ops, f0, f1, r, out, problems, m, n, k, ldc,
                                          k_per, device, s);
  return (int)fern::launch_tf32_act<128>(act, ops, f0, f1, r, out, problems, m, n, k, ldc,
                                         k_per, device, s);
}
