// The bf16 GEMM with a fused epilogue: C = [res +] cast(act(A . Bt^T + bias)).
//
// The four products inside kernels B1 and B2 in bf16: the QKV projection and the
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
// 512..3072) the bf16 products are compute-bound on the tensor cores
// (a 128 x 256 x 64 tile does 4.2 MFLOP per 48 KB it loads). The TPU
// kernel kept both weight matrices resident in 16+ MB of VMEM; 227 KB of
// shared memory cannot, so weights stream through shared memory tile by
// tile and the 50 MB L2 keeps them hot across the row blocks.
// Design, bf16: warpgroup MMA (`gemm_wgmma.cuh`) on tiles that TMA
// brings into shared memory. A block of 288 threads takes a 128 x BN
// output tile: one producer warp keeps a ring of STAGES (A, Bt) K tiles
// in flight with `cp.async.bulk.tensor` (tensor maps in the 128-byte
// swizzle, zero-filled past the matrix, so ragged M, N and K need no
// masks in the main loop), each stage with a "full" mbarrier (the
// copies' bytes) and an "empty" one (the eight consumer warps); two
// consumer warpgroups wait on "full", issue `wgmma` on their 64-row
// slabs, keep one K tile's products in flight and release the stage
// before; the epilogue goes through the ring, turned scratch. BN = 128
// (three stages, two blocks an SM, so one block's epilogue overlaps the
// other's products) or 256 (four stages, one block an SM), by
// `pick_tile`; `fern_gemm`'s `tile` argument forces either. The fp32
// products of the same kernels run by 3xTF32 in gemm_tf32.cu.

#include <mutex>

#include "gemm_wgmma.cuh"
#include "tma.cuh"

namespace fern {

constexpr int kProducerWarp = kConsumerThreads / 32;  // warp 8
constexpr int kGemmThreads = kConsumerThreads + 32;

// A tile width, the ring's depth and the blocks an SM holds.
template <int BN, int STAGES, int BLOCKS>
struct GemmConfig {
  static constexpr int kStageBytes = kTileABytes + BN * kGemmBK * 2;
  static constexpr size_t kRing = (size_t)STAGES * kStageBytes;
  static constexpr size_t kData = kRing > scratch_bytes(BN) ? kRing : scratch_bytes(BN);
  // alignment slack, the ring (after the last K tile, the epilogue
  // scratch), 2 x STAGES mbarriers
  static constexpr size_t kSmem = 1024 + kData + 2 * STAGES * sizeof(uint64_t);
};

// The output tile at rows blockIdx.y * 128.., columns blockIdx.x * BN..
template <int BN, int STAGES, int BLOCKS>
__global__ void __launch_bounds__(kGemmThreads, BLOCKS)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ bias,
                 const bf16* __restrict__ res, bf16* __restrict__ C, int M, int N, int K,
                 int ldc, int act) {
  using Cfg = GemmConfig<BN, STAGES, BLOCKS>;
  constexpr int S = STAGES, NB = BN / kMmaN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = smem_addr(smem + Cfg::kData), empty = full + S * sizeof(uint64_t);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bm = blockIdx.y * kGemmBM, bn = blockIdx.x * BN;
  const int kt_count = (K + kGemmBK - 1) / kGemmBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s * sizeof(uint64_t), 1);
      mbar_init(empty + s * sizeof(uint64_t), kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // the producer: one thread issues every copy; the warp keeps few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (lane == 0) {
      for (int kt = 0; kt < kt_count; ++kt) {
        const int s = kt % S;
        const uint32_t f = full + s * sizeof(uint64_t);
        if (kt >= S) mbar_wait(empty + s * sizeof(uint64_t), ((kt / S) - 1) & 1);
        mbar_expect_tx(f, Cfg::kStageBytes);
        const uint32_t a = ring + s * Cfg::kStageBytes;
        tma_load(&map_a, a, f, kt * kGemmBK, bm);
        tma_load(&map_b, a + kTileABytes, f, kt * kGemmBK, bn);
      }
    }
  } else {
    // two consumer warpgroups, 64 rows each
    const int wg = threadIdx.x / 128;
    float acc[NB][64];
    zero_acc(acc);
    for (int kt = 0; kt < kt_count; ++kt) {
      const int s = kt % S;
      mbar_wait(full + s * sizeof(uint64_t), (kt / S) & 1);
      const uint32_t a = ring + s * Cfg::kStageBytes;
      fence_acc(acc);
      wgmma_fence();
      mma_ktile<NB>(acc, a + wg * kWgRows * 128, a + kTileABytes);
      wgmma_commit();
      wgmma_wait<1>();  // the K tile before this one is multiplied: release its stage
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + ((kt - 1) % S) * sizeof(uint64_t));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // every copy has landed and been read: the ring turns into the scratch
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(3, kConsumerThreads);
    wg_epilogue<NB>(acc, reinterpret_cast<bf16*>(smem) + wg * kWgRows * scratch_ld(BN),
                    threadIdx.x % 128, 1 + wg, bias, res, C, M, N, ldc, act,
                    bm + wg * kWgRows, bn);
  }
}

// The tensor map of a row-major bf16 [rows, k] matrix read in boxes of
// box_rows x 64, in the 128-byte swizzle, zero past its edges.
static cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), ptr, rows, k, kGemmBK,
                  box_rows);
}

// Tile width of the rule, from the two widths' times on an H100 at the
// ViT-B-16 and RN50x4 products (`chip_smoke.py` phase 2): 128 x 128 tiles,
// two blocks an SM (one block's epilogue overlaps the other's products),
// except where K is deep enough to amortize a 128 x 256 tile's epilogue
// (K >= 2,048) and its tiles fill four waves of one block an SM.
static int pick_tile(int m, int n, int k, int sms) {
  const long long tiles = (long long)((m + kGemmBM - 1) / kGemmBM) * ((n + 255) / 256);
  return k >= 2048 && n % 256 == 0 && tiles >= 4LL * sms ? 256 : 128;
}

template <int BN, int STAGES, int BLOCKS>
static cudaError_t launch_bf16(const void* a, const void* bt, const void* bias, const void* res,
                               void* c, int m, int n, int k, int ldc, int act, int device,
                               cudaStream_t stream) {
  using Cfg = GemmConfig<BN, STAGES, BLOCKS>;
  static std::mutex mu;
  static bool opted[kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          gemm_bf16_kernel<BN, STAGES, BLOCKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)Cfg::kSmem);
      if (err != cudaSuccess) return err;
      opted[device] = true;
    }
  }
  CUtensorMap map_a, map_b;
  cudaError_t err = bf16_map(&map_a, a, m, k, kGemmBM);
  if (err != cudaSuccess) return err;
  err = bf16_map(&map_b, bt, n, k, BN);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + kGemmBM - 1) / kGemmBM);
  gemm_bf16_kernel<BN, STAGES, BLOCKS><<<grid, kGemmThreads, Cfg::kSmem, stream>>>(
      map_a, map_b, static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(c), m, n, k, ldc, act);
  return cudaGetLastError();
}

}  // namespace fern

// ldc: C's row stride in elements (n for a contiguous C; a multiple of
// 8, for the 16-byte stores). Takes a and bt at 16-byte aligned
// addresses with k % 8 == 0 (TMA's rule for a base and a row stride) and
// refuses anything else; `tile`: 0 for the rule, or 128 / 256 to force
// that tile width (timings of the two). dtype: bf16 only (fp32 products
// go to `fern_gemm_tf32`).
extern "C" int fern_gemm(const void* a, const void* bt, const void* bias, const void* res,
                         void* c, int m, int n, int k, int ldc, int act, int dtype, int tile,
                         int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (ldc < n) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(a) | reinterpret_cast<unsigned long long>(bt) |
      reinterpret_cast<unsigned long long>(c);
  if (dtype != fern::DTYPE_BF16 || addr % 16 || k % 8 || n % 8 || ldc % 8)
    return (int)cudaErrorInvalidValue;
  if (tile == 0) tile = fern::pick_tile(m, n, k, fern::sm_count(device));
  switch (tile) {
    case 128:
      return (int)fern::launch_bf16<128, 3, 2>(a, bt, bias, res, c, m, n, k, ldc, act, device,
                                               s);
    case 256:
      return (int)fern::launch_bf16<256, 4, 1>(a, bt, bias, res, c, m, n, k, ldc, act, device,
                                               s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
