// The bf16 GEMM's MMA body on Hopper's warpgroup MMA, shared by gemm.cu
// (kernels B1, B2, B7 and B12 in bf16, fed by TMA) and block.cu (kernel
// B10's four products, fed by cp.async):
//
//     C = [res +] cast(act(A . Bt^T + bias))
//
// Layouts: A [M, K] row-major (activations), Bt [N, K] row-major (the
// torch Linear layout, out x in), res [M, N], C [M, N] at row stride
// ldc >= N. Both operands are K-major, as `wgmma` reads them with no
// transpose.
//
// Operand tiles: 64 elements of K (128 bytes) a row, rows 128 bytes
// apart, in the 128-byte swizzle (16-byte chunk c of row r sits at chunk
// c ^ (r % 8)) that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and the
// `wgmma` descriptors' layout type 1 reads; every tile starts on a
// 1,024-byte boundary (one swizzle atom of 8 rows).
//
// A consumer warpgroup (128 threads) owns 64 rows of the block tile and
// NB x 128 of its columns: per 64-deep K tile it issues, for k16 steps in
// ascending k order, NB `wgmma.mma_async.m64n128k16.f32.bf16.bf16` into
// fp32 accumulators that start at zero. The bits of C depend only on
// that sequence of instructions, not on how the operands reached shared
// memory or which tile width the launcher chose: so B10, which runs the
// same body on the same k order, stays bit for bit equal to B1 + B2.
//
// The epilogue goes through shared memory: a warpgroup applies bias and
// activation in fp32 and the cast to its accumulators and writes them to
// a [64, NB*128 + 8] bf16 scratch, then each thread adds the residual in
// bf16 to 8 consecutive columns of a row and writes them as one 16-byte
// store (`epilogue<bf16>` of common.cuh, the Pallas kernels' rounding
// points).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace fern {

constexpr int kGemmBM = 128;    // rows of a block tile: two warpgroups of 64
constexpr int kGemmBK = 64;     // K of a tile: one 128-byte swizzle row
constexpr int kWgRows = 64;     // rows of a warpgroup's slab (the wgmma M)
constexpr int kMmaN = 128;      // columns of one wgmma (n128)
constexpr int kConsumerThreads = 256;
// gemm.cu and qgemm.cu: the two consumer warpgroups and one producer warp
constexpr int kProducerWarp = kConsumerThreads / 32;  // warp 8
constexpr int kGemmThreads = kConsumerThreads + 32;
constexpr int kTileABytes = kGemmBM * kGemmBK * 2;  // 16 KB

__host__ __device__ constexpr int scratch_ld(int bn) { return bn + 8; }

// Shared memory of the epilogue scratch (bf16) for a block tile of bn columns.
__host__ __device__ constexpr size_t scratch_bytes(int bn) {
  return (size_t)kGemmBM * scratch_ld(bn) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// First 1,024-byte boundary at or after p (the swizzle atom).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading byte offset 16 (unused by this layout),
// stride byte offset 1,024 (from one 8-row group to the next), layout
// type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma (the instructions name them only as
// in-out operands of the issuing asm).
template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][64]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[nb][i])::"memory");
}

// D[64, 128] += A[64, 16] . B[128, 16]^T, both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// One 64-deep K tile of a warpgroup's slab: a_addr is the first of its 64
// rows of A, b_addr the first of NB x 128 rows of Bt, both swizzled.
// Within the 128-byte row, k16 step kk starts 32 bytes further.
template <int NB>
__device__ __forceinline__ void mma_ktile(float (&acc)[NB][64], uint32_t a_addr,
                                          uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kGemmBK / 16; ++kk) {
    const uint64_t da = wgmma_desc(a_addr + kk * 32);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_m64n128k16(acc[nb], da, wgmma_desc(b_addr + nb * kMmaN * 128 + kk * 32));
  }
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][64]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[nb][i] = 0.0f;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The epilogue of a warpgroup's slab: rows row0.. (64 of them), columns
// bn.. (NB x 128). `scr` is this warpgroup's [64, scratch_ld] bf16 scratch;
// `t` its thread index (0..127), `bar` a named barrier id no other
// warpgroup uses. Two passes of `epilogue<bf16>`: first, in the
// accumulators' fragment layout, bias and activation in fp32 and the
// cast (no residual), into the scratch; then, 8 consecutive columns of
// a row a thread, the residual added in bf16 and one 16-byte store. The
// second pass adds a value that is already bf16, so the two give the
// bits of one `epilogue<bf16>` with the residual. Every load of a batch
// (a block's bias, four chunks of the residual) is issued before its
// stores, so that their latencies overlap. res is read 16 bytes at a
// time where it is 16-byte aligned, element by element otherwise.
// Ends with the barrier: the scratch is free again when it returns.
template <int NB, int ACT>
__device__ __forceinline__ void wg_epilogue_act(float (&acc)[NB][64], bf16* scr, int t,
                                                int bar, const bf16* __restrict__ bias,
                                                const bf16* __restrict__ res,
                                                bf16* __restrict__ C, int M, int N, int ldc,
                                                int row0, int bn) {
  constexpr int kLd = scratch_ld(NB * kMmaN), kChunks = NB * kMmaN / 8;
  constexpr int kIters = kWgRows * kChunks / 128, kBatch = 4;
  const bf16* no_res = nullptr;
  // accumulator fragment of m64nNk16: warp w holds rows 16w.., lane l
  // rows l/4 and l/4 + 8, columns 8j + 2(l%4) and the next of each n8 block j
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    bf16 bl[kMmaN / 4];  // the bias at this thread's 32 columns of block nb
#pragma unroll
    for (int j = 0; j < kMmaN / 8; ++j) {
      const int gn = bn + nb * kMmaN + 8 * j + c;
      const bool in = bias != nullptr && gn < N;  // N % 8 == 0: the pair is in or out
      bl[2 * j] = in ? bias[gn] : bf16();
      bl[2 * j + 1] = in ? bias[gn + 1] : bf16();
    }
    const bf16* b = bias != nullptr ? bl : nullptr;
#pragma unroll
    for (int j = 0; j < kMmaN / 8; ++j) {
      const int col = nb * kMmaN + 8 * j + c;
      const float* d = &acc[nb][4 * j];
      *reinterpret_cast<__nv_bfloat162*>(&scr[r * kLd + col]) =
          __halves2bfloat162(epilogue<bf16>(d[0], b, no_res, 0, 2 * j, ACT),
                             epilogue<bf16>(d[1], b, no_res, 0, 2 * j + 1, ACT));
      *reinterpret_cast<__nv_bfloat162*>(&scr[(r + 8) * kLd + col]) =
          __halves2bfloat162(epilogue<bf16>(d[2], b, no_res, 0, 2 * j, ACT),
                             epilogue<bf16>(d[3], b, no_res, 0, 2 * j + 1, ACT));
    }
  }
  named_barrier(bar, 128);
  const bool vec = (reinterpret_cast<uintptr_t>(res) & 15) == 0;
  const bf16* no_bias = nullptr;
#pragma unroll
  for (int i0 = 0; i0 < kIters; i0 += kBatch) {
    __align__(16) bf16 v[kBatch][8], r8[kBatch][8];
    int gm[kBatch], gn[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = t + 128 * (i0 + u), lr = i / kChunks, lc = 8 * (i % kChunks);
      gm[u] = row0 + lr;
      gn[u] = bn + lc;
      *reinterpret_cast<uint4*>(v[u]) = *reinterpret_cast<const uint4*>(&scr[lr * kLd + lc]);
      if (res == nullptr || gm[u] >= M || gn[u] >= N) continue;  // a chunk is in or out
      const size_t idx = (size_t)gm[u] * N + gn[u];
      if (vec) *reinterpret_cast<uint4*>(r8[u]) = *reinterpret_cast<const uint4*>(res + idx);
      else
#pragma unroll
        for (int e = 0; e < 8; ++e) r8[u][e] = res[idx + e];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (gm[u] >= M || gn[u] >= N) continue;
      __align__(16) bf16 out[8];
      if (res == nullptr) {
        *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = epilogue<bf16>(to_f(v[u][e]), no_bias, r8[u], e, e, ACT_NONE);
      }
      *reinterpret_cast<uint4*>(C + (size_t)gm[u] * ldc + gn[u]) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
  named_barrier(bar, 128);
}

// `wg_epilogue_act` with the activation a constant of each instance: a
// run-time code inside the unrolled body would let the compiler predicate
// every activation's arithmetic into every element.
template <int NB>
__device__ __forceinline__ void wg_epilogue(float (&acc)[NB][64], bf16* scr, int t, int bar,
                                            const bf16* bias, const bf16* res, bf16* C, int M,
                                            int N, int ldc, int act, int row0, int bn) {
  switch (act) {
    case ACT_QUICK_GELU:
      wg_epilogue_act<NB, ACT_QUICK_GELU>(acc, scr, t, bar, bias, res, C, M, N, ldc, row0, bn);
      break;
    case ACT_GELU:
      wg_epilogue_act<NB, ACT_GELU>(acc, scr, t, bar, bias, res, C, M, N, ldc, row0, bn);
      break;
    case ACT_RELU:
      wg_epilogue_act<NB, ACT_RELU>(acc, scr, t, bar, bias, res, C, M, N, ldc, row0, bn);
      break;
    default:
      wg_epilogue_act<NB, ACT_NONE>(acc, scr, t, bar, bias, res, C, M, N, ldc, row0, bn);
  }
}

// ---- B10's tile: the same body fed by cp.async ----------------------------

constexpr int kCpStages = 2;
constexpr int kCpStageBytes = 2 * kTileABytes;  // A and Bt, 128 rows each

// Shared memory of B10's bf16 tile: the two-stage ring (or, after the
// last K tile, the epilogue scratch) and 1,024 bytes of alignment slack.
__host__ __device__ constexpr size_t wgmma_tile_smem_bytes() {
  return 1024 + ((size_t)kCpStages * kCpStageBytes > scratch_bytes(kMmaN)
                     ? (size_t)kCpStages * kCpStageBytes
                     : scratch_bytes(kMmaN));
}

// 128 rows x 64 of K of a row-major [rows, K] matrix into a swizzled tile;
// rows and columns past the matrix are zero-filled (K % 8 == 0).
__device__ __forceinline__ void load_tile_swizzled(unsigned char* dst, const bf16* src,
                                                   int row0, int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < kGemmBM * 8 / kConsumerThreads; ++i) {
    const int ch = threadIdx.x + i * kConsumerThreads;
    const int r = ch / 8, kc = ch % 8;
    const bool ok = (row0 + r < rows) && (k0 + 8 * kc < K);
    const bf16* g = ok ? src + (size_t)(row0 + r) * K + k0 + 8 * kc : src;
    cp_async16(dst + r * 128 + ((kc ^ (r & 7)) * 16), g, ok);
  }
}

// The bf16 128 x 128 output tile at rows bm.., columns bn.., for a block
// of 256 threads (two consumer warpgroups, each also a loader): K tiles
// double-buffered through cp.async, the next one loading while this one
// multiplies. Ends with a block barrier: the caller may reuse the shared
// memory right after.
__device__ __forceinline__ void gemm_bf16_tile(unsigned char* smem_raw,
                                               const bf16* __restrict__ A,
                                               const bf16* __restrict__ Bt,
                                               const bf16* __restrict__ bias,
                                               const bf16* __restrict__ res,
                                               bf16* __restrict__ C, int M, int N, int K,
                                               int ldc, int act, int bm, int bn) {
  unsigned char* smem = align_1024(smem_raw);
  const int wg = threadIdx.x / 128;
  float acc[1][64];
  zero_acc(acc);
  const int kt_count = (K + kGemmBK - 1) / kGemmBK;
  load_tile_swizzled(smem, A, bm, M, 0, K);
  load_tile_swizzled(smem + kTileABytes, Bt, bn, N, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    unsigned char* stage = smem + (kt & 1) * kCpStageBytes;
    if (kt + 1 < kt_count) {
      unsigned char* next = smem + ((kt + 1) & 1) * kCpStageBytes;
      load_tile_swizzled(next, A, bm, M, (kt + 1) * kGemmBK, K);
      load_tile_swizzled(next + kTileABytes, Bt, bn, N, (kt + 1) * kGemmBK, K);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile kt has landed; tile kt+1 may be in flight
    // the generic-proxy writes of cp.async become visible to wgmma's
    // async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    fence_acc(acc);
    wgmma_fence();
    mma_ktile<1>(acc, smem_addr(stage) + wg * kWgRows * 128, smem_addr(stage + kTileABytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // both warpgroups are done with this stage before it refills
  }
  wg_epilogue<1>(acc, reinterpret_cast<bf16*>(smem) + wg * kWgRows * scratch_ld(kMmaN),
                 threadIdx.x % 128, 1 + wg, bias, res, C, M, N, ldc, act, bm + wg * kWgRows,
                 bn);
  __syncthreads();  // the scratch is read before anyone refills the ring
}

}  // namespace fern
