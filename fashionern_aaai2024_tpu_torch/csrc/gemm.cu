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
// `pick_tile`; `fern_gemm`'s `tile` argument forces either. fp32: SIMT
// FMA 64 x 64 tiles, full fp32, as the fp32 parity tier needs. A split-K
// entry (`fern_gemm_f32_partials`) writes one fp32 partial product per
// slice of K for kernel B12's hidden layer, where a few row tiles against
// a deep K would leave most SMs idle or waiting on memory.

#include <cuda.h>

#include <atomic>
#include <mutex>

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace fern {

constexpr int kProducerWarp = kConsumerThreads / 32;  // warp 8
constexpr int kGemmThreads = kConsumerThreads + 32;
// A wait longer than this many SM clock cycles (~10 s) means a copy or a
// release never came: the kernel traps (a launch error) instead of hanging.
constexpr long long kWaitTimeout = 1LL << 34;

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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitTimeout) __trap();
  }
}
// One box of a 2-D tensor map (coordinates: k, row) into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

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

// cuTensorMapEncodeTiled from the driver, found once through the
// runtime (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a row-major bf16 [rows, k] matrix read in boxes of
// box_rows x 64, in the 128-byte swizzle, zero past its edges.
static cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kGemmBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// SM count of a device, read once.
static int sm_count(int device) {
  static std::atomic<int> sms[kMaxDevices];
  int n = sms[device].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    sms[device].store(n, std::memory_order_relaxed);
  }
  return n;
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
// 8 in bf16, for the 16-byte stores). bf16 takes a and bt at 16-byte
// aligned addresses with k % 8 == 0 (TMA's rule for a base and a row
// stride) and refuses anything else; `tile`: 0 for the rule, or 128 /
// 256 to force that tile width (bf16 only; timings of the two).
extern "C" int fern_gemm(const void* a, const void* bt, const void* bias, const void* res,
                         void* c, int m, int n, int k, int ldc, int act, int dtype, int tile,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ldc < n) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16) {
    const unsigned long long addr =
        reinterpret_cast<unsigned long long>(a) | reinterpret_cast<unsigned long long>(bt) |
        reinterpret_cast<unsigned long long>(c);
    if (addr % 16 || k % 8 || n % 8 || ldc % 8 || device < 0 || device >= fern::kMaxDevices)
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
