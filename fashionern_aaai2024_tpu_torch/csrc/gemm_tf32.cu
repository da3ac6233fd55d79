// Kernel B12's fp32 products on the tensor cores, at fp32 accuracy:
//
//     C[:, p*N : (p+1)*N] = act(A_p . B_p^T + bias_p),  p < problems (1 or 2)
//
// or, split over K, one fp32 partial product per K slice (no bias, no
// activation; the row kernel of combiner.cu sums them).
//
// Replaces: the three products of `_combiner_kernel` / `_combiner_pallas`
// (fashionern_aaai2024_tpu/ops/combiner.py:35-59, 63): the two ReLU
// projections (both in one launch, problems = 2, each writing its half of
// the [M, 8d] concat buffer) and the hidden layer [M, 8d] x [8d, 8d]^T. On
// the TPU an fp32 product at the highest precision is itself a multi-pass
// product in a narrower type; here it is 3xTF32: each operand x is split
// as hi = tf32(x) (rounded as `cvt.rna.tf32.f32` rounds) and lo =
// tf32(x - hi), and lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (the small terms
// first) is accumulated in fp32 by `wgmma.mma_async.m64n128k8.f32.tf32.tf32`; the
// dropped lo_a.lo_b is ~2^-22 of a product.
//
// Layouts: A [M, K] and B [N, K] row-major (the activations and the torch
// Linear weight), both K-major as `wgmma` reads tf32; C at row stride
// ldc. K % 4 == 0 and 16-byte aligned A and B (TMA's rules); N % 8 == 0.
//
// Bound: at M = 1024 the 3 x 38.7 GFLOP (d = 512) on the tensor cores
// (0.234 ms at 495 TFLOP/s); at M <= 128 the weights' bytes (W_h is 64 MB
// at d = 512).
// Design: the TMA ring of gemm.cu. A block of 288 threads takes a
// 128 x 128 output tile: one producer warp keeps five stages of (A, B)
// 32-deep K tiles (128 bytes a row, the 128-byte swizzle) in flight, each
// with a full and an empty mbarrier. The two consumer warpgroups (64 rows
// each) take a stage that landed as follows: B (the weight tile) is split
// into one of two operand buffers (hi and lo in the same swizzle) by all
// 256 threads with 16-byte shared loads and stores; A goes from the stage
// straight into registers, each warpgroup its own 64 rows in the wgmma
// register fragment, and is split there; then the stage goes back to the
// producer, the split B is made visible to the async proxy
// (`fence.proxy.async`), and after a named barrier each warpgroup issues
// the three wgmmas a k8 step (A from registers, B from shared memory),
// keeping one K tile's wgmmas in flight while it takes the next (the
// register sets alternate by K tile). The three products read B three
// times and the split adds its own shared-memory reads and writes, so A
// comes from registers and only B is split into shared memory: shared
// memory's bandwidth, beside the tensor cores, sets a K tile's time. A
// k8 tf32 step spans the 32 bytes of a k16 bf16 step, so the B
// descriptors are the bf16 GEMM's (`gemm_wgmma.cuh`). Every warpgroup
// issues its wgmmas, also where its 64 rows all lie past M (zeros from
// TMA's fill): a branch around them would make ptxas serialize every
// wgmma of the kernel. The split costs no device memory: the weights
// stay as they are.

#include <mutex>

#include "gemm_wgmma.cuh"
#include "tma.cuh"

namespace fern {

constexpr int kTfBM = 128, kTfBN = 128, kTfBK = 32;  // a K tile: 32 fp32 = 128 bytes a row
constexpr int kTfStages = 5;                         // the TMA ring: raw (A, B) K tiles
constexpr int kTfTileBytes = kTfBM * kTfBK * 4;      // 16 KB: A's (and B's) tile
constexpr int kTfStageBytes = 2 * kTfTileBytes;      // a ring stage: A, then B, as loaded
constexpr int kTfOperandBytes = 2 * kTfTileBytes;    // an operand buffer: B hi, then B lo
constexpr int kTfThreads = kConsumerThreads + 32;    // two warpgroups and a producer warp
constexpr int kTfProducerWarp = kConsumerThreads / 32;
// alignment slack, the ring, two operand buffers, 2 x kTfStages mbarriers
// (230,480 bytes of the 232,448 a block may have)
constexpr size_t kTfRing = (size_t)kTfStages * kTfStageBytes;
constexpr size_t kTfSmem = 1024 + kTfRing + 2 * kTfOperandBytes +
                           2 * kTfStages * sizeof(uint64_t);

// x rounded to tf32 as `cvt.rna.tf32.f32` rounds (to nearest, ties away
// from zero), as an fp32 value with the low 13 mantissa bits zero: half
// of the dropped bits is added to the magnitude, then they are cleared.
// Two integer operations; the same bits as cvt.rna for every finite x and
// for infinities.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// lo = tf32(x - hi) of x = hi + lo, hi = tf32(x) given.
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// D[64, 128] += A[64, 8] . B[128, 8]^T: A from registers (the fragment of
// `load_a`), B from shared memory.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A K tile's A operand of one warpgroup, split: hi and lo of the four
// k8 steps' register fragments.
struct TfA {
  uint32_t hi[kTfBK / 8][4], lo[kTfBK / 8][4];
};

// Keeps the compiler from sinking the A fragments' split past the
// `wgmma.fence` that must follow their last write (else ptxas inserts a
// fence of its own, in a divergent path, and serializes every wgmma).
__device__ __forceinline__ void fence_a(TfA& a) {
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(a.hi[kk][j]), "+r"(a.lo[kk][j])::"memory");
}

// Loads this thread's A fragments of a K tile from the swizzled stage and
// splits them. Fragment of m64nNk8 tf32 (per warp, rows 16w..16w+15 of
// the warpgroup's 64): a0 (row l/4, k l%4), a1 (row l/4 + 8, k l%4), a2
// and a3 the same rows at k l%4 + 4; element (r, k) of the tile sits at
// r * 128 + ((k / 4) ^ (r % 8)) * 16 + (k % 4) * 4 (the 128-byte swizzle).
// t: the thread in its warpgroup; a_tile: the warpgroup's 64 rows.
__device__ __forceinline__ void load_a(TfA& a, const unsigned char* a_tile, int t) {
  const int g = (t % 32) / 4, c = t % 4;
  const unsigned char* r0 = a_tile + (16 * (t / 32) + g) * 128 + c * 4;
  const unsigned char* r1 = r0 + 8 * 128;
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk) {
    const int c0 = ((2 * kk) ^ g) * 16, c1 = ((2 * kk + 1) ^ g) * 16;
    const float x[4] = {*reinterpret_cast<const float*>(r0 + c0),
                        *reinterpret_cast<const float*>(r1 + c0),
                        *reinterpret_cast<const float*>(r0 + c1),
                        *reinterpret_cast<const float*>(r1 + c1)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.hi[kk][j] = tf32_rna(x[j]);
      a.lo[kk][j] = tf32_lo(x[j], a.hi[kk][j]);
    }
  }
}

// Splits the B tile of the ring stage that landed into an operand buffer:
// hi at the same offset, lo 16 KB on. t: the consumer thread, 0..255.
__device__ __forceinline__ void split_b(const unsigned char* b_tile, unsigned char* operands,
                                        int t) {
  const uint4* raw = reinterpret_cast<const uint4*>(b_tile);
  uint4* hi = reinterpret_cast<uint4*>(operands);
  uint4* lo = reinterpret_cast<uint4*>(operands + kTfTileBytes);
#pragma unroll
  for (int i = 0; i < kTfTileBytes / 16 / kConsumerThreads; ++i) {
    const int c = t + i * kConsumerThreads;
    const uint4 v = raw[c];
    const uint4 h = make_uint4(tf32_rna(__uint_as_float(v.x)), tf32_rna(__uint_as_float(v.y)),
                               tf32_rna(__uint_as_float(v.z)), tf32_rna(__uint_as_float(v.w)));
    hi[c] = h;
    lo[c] = make_uint4(tf32_lo(__uint_as_float(v.x), h.x), tf32_lo(__uint_as_float(v.y), h.y),
                       tf32_lo(__uint_as_float(v.z), h.z), tf32_lo(__uint_as_float(v.w), h.w));
  }
}

// One K tile of a consumer thread: wait for its stage, split B into
// operand buffer i % 2, load and split A into `a`, give the stage back,
// and issue the tile's wgmmas (lo_a.hi_b, hi_a.lo_b, hi_a.hi_b a k8
// step) with one K tile's wgmmas left in flight.
__device__ __forceinline__ void tf32_ktile(float (&acc)[1][64], TfA& a, int i,
                                           unsigned char* smem, unsigned char* operands,
                                           uint32_t full, uint32_t empty) {
  const int s = i % kTfStages, wg = threadIdx.x / 128;
  unsigned char* stage = smem + (size_t)s * kTfStageBytes;
  unsigned char* ops = operands + (i % 2) * kTfOperandBytes;
  mbar_wait(full + s * sizeof(uint64_t), (i / kTfStages) & 1);
  // both warpgroups are past their wait for the K tile two back, whose
  // wgmmas read this operand buffer
  named_barrier(1, kConsumerThreads);
  split_b(stage + kTfTileBytes, ops, threadIdx.x);
  load_a(a, stage + wg * kWgRows * 128, threadIdx.x % 128);
  fence_a(a);
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty + s * sizeof(uint64_t));  // refill the stage
  // the split's generic-proxy writes become visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2, kConsumerThreads);
  const uint32_t b_hi = smem_addr(ops);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk) {
    const uint64_t bh = wgmma_desc(b_hi + kk * 32);
    const uint64_t bl = wgmma_desc(b_hi + kTfTileBytes + kk * 32);
    wgmma_m64n128k8_tf32(acc[0], a.lo[kk], bh);
    wgmma_m64n128k8_tf32(acc[0], a.hi[kk], bl);
    wgmma_m64n128k8_tf32(acc[0], a.hi[kk], bh);
  }
  wgmma_commit();
  wgmma_wait<1>();  // the K tile before this one is multiplied
  fence_acc(acc);
}

// The output tile at rows blockIdx.y * 128.., columns (blockIdx.x % tiles
// of N) * 128.. of problem blockIdx.x / (tiles of N), over the K tiles of
// slice blockIdx.z (k_per elements each).
__global__ void __launch_bounds__(kTfThreads, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_a0,
                 const __grid_constant__ CUtensorMap map_b0,
                 const __grid_constant__ CUtensorMap map_a1,
                 const __grid_constant__ CUtensorMap map_b1, const float* __restrict__ bias0,
                 const float* __restrict__ bias1, float* __restrict__ C, int M, int N, int K,
                 int ldc, bool relu, int k_per) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* operands = smem + kTfRing;  // two operand buffers
  const uint32_t full = smem_addr(operands + 2 * kTfOperandBytes);
  const uint32_t empty = full + kTfStages * sizeof(uint64_t);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (N + kTfBN - 1) / kTfBN;
  const int problem = blockIdx.x / n_tiles;
  const int bm = blockIdx.y * kTfBM, bn = (blockIdx.x % n_tiles) * kTfBN;
  const int k0 = blockIdx.z * k_per;
  const int k1 = min(K, k0 + k_per);
  const int kt_count = k1 > k0 ? (k1 - k0 + kTfBK - 1) / kTfBK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(full + s * sizeof(uint64_t), 1);
      mbar_init(empty + s * sizeof(uint64_t), kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTfProducerWarp) {
    if (lane == 0) {
      const CUtensorMap* map_a = problem ? &map_a1 : &map_a0;
      const CUtensorMap* map_b = problem ? &map_b1 : &map_b0;
      for (int i = 0; i < kt_count; ++i) {
        const int s = i % kTfStages;
        const uint32_t f = full + s * sizeof(uint64_t);
        if (i >= kTfStages) mbar_wait(empty + s * sizeof(uint64_t), ((i / kTfStages) - 1) & 1);
        mbar_expect_tx(f, kTfStageBytes);
        const uint32_t a = smem_addr(smem + (size_t)s * kTfStageBytes);
        tma_load(map_a, a, f, k0 + i * kTfBK, bm);
        tma_load(map_b, a + kTfTileBytes, f, k0 + i * kTfBK, bn);
      }
    }
    return;
  }

  float acc[1][64];
  zero_acc(acc);
  // two register sets for A, by K tile: the wgmmas of one may still read
  // its set while the next K tile loads the other
  TfA a0, a1;
  int i = 0;
  for (; i + 1 < kt_count; i += 2) {
    tf32_ktile(acc, a0, i, smem, operands, full, empty);
    tf32_ktile(acc, a1, i + 1, smem, operands, full, empty);
  }
  if (i < kt_count) tf32_ktile(acc, a0, i, smem, operands, full, empty);
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator fragment of m64nNk8: warp w holds rows 16w.., lane l rows
  // l/4 and l/4 + 8, columns 8j + 2(l%4) and the next of each n8 block j
  const int t = threadIdx.x % 128;
  const int r = bm + (threadIdx.x / 128) * kWgRows + 16 * (t / 32) + (t % 32) / 4;
  const float* bias = problem ? bias1 : bias0;
  float* out = C + (size_t)blockIdx.z * M * ldc + (size_t)problem * N;
#pragma unroll
  for (int j = 0; j < kTfBN / 8; ++j) {
    const int col = bn + 8 * j + 2 * (t % 4);
    if (col >= N) continue;  // N % 8 == 0: the pair is in or out
    float2 b2 = make_float2(0.f, 0.f);
    if (bias != nullptr) b2 = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M) continue;
      float2 v = make_float2(acc[0][4 * j + 2 * h] + b2.x, acc[0][4 * j + 2 * h + 1] + b2.y);
      if (relu) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
      *reinterpret_cast<float2*>(out + (size_t)row * ldc + col) = v;
    }
  }
}

static cudaError_t f32_map(CUtensorMap* map, const void* ptr, int rows, int k) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), ptr, rows, k, kTfBK,
                  kTfBM);
}

}  // namespace fern

// problems = 1 or 2: problem p computes C[:, p*n : (p+1)*n] = act(a_p .
// b_p^T + bias_p) for a_p [m, k], b_p [n, k] (a1, b1, bias1 unused when
// problems = 1). k_per: the K slice of a grid layer, a multiple of 32; with
// k_per < k (one problem, no bias, no activation) slice z writes its
// partial product to C + z * m * ldc. C's row stride ldc is even; bias_p
// may be null (else 8-byte aligned); act: ACT_NONE or ACT_RELU. All fp32.
extern "C" int fern_gemm_tf32(const void* a0, const void* b0, const void* bias0,
                              const void* a1, const void* b1, const void* bias1, void* c,
                              int problems, int m, int n, int k, int ldc, int act, int k_per,
                              int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const bool split = k_per < k;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(a0) | reinterpret_cast<unsigned long long>(b0) |
      (problems == 2 ? reinterpret_cast<unsigned long long>(a1) |
                           reinterpret_cast<unsigned long long>(b1)
                     : 0ULL);
  const unsigned long long bias_addr =
      reinterpret_cast<unsigned long long>(bias0) | reinterpret_cast<unsigned long long>(bias1);
  if (problems < 1 || problems > 2 || addr % 16 || bias_addr % 8 || k % 4 || n % 8 ||
      ldc % 2 || ldc < problems * n || k_per < fern::kTfBK || k_per % fern::kTfBK ||
      (act != fern::ACT_NONE && act != fern::ACT_RELU) ||
      (split && (problems != 1 || bias0 != nullptr || act != fern::ACT_NONE)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  static std::mutex mu;
  static bool opted[fern::kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted[device]) {
      err = cudaFuncSetAttribute(fern::gemm_tf32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)fern::kTfSmem);
      if (err != cudaSuccess) return (int)err;
      opted[device] = true;
    }
  }
  CUtensorMap maps[4];
  const void* ops[4] = {a0, b0, problems == 2 ? a1 : a0, problems == 2 ? b1 : b0};
  for (int i = 0; i < 4; ++i) {
    if (i >= 2 && problems == 1) {
      maps[i] = maps[i - 2];
      continue;
    }
    err = fern::f32_map(&maps[i], ops[i], i % 2 ? n : m, k);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(problems * ((n + fern::kTfBN - 1) / fern::kTfBN),
                  (m + fern::kTfBM - 1) / fern::kTfBM, (k + k_per - 1) / k_per);
  fern::gemm_tf32_kernel<<<grid, fern::kTfThreads, fern::kTfSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias0),
      static_cast<const float*>(bias1), static_cast<float*>(c), m, n, k, ldc,
      act == fern::ACT_RELU, k_per);
  return (int)cudaGetLastError();
}
