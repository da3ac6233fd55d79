// The port's fp32-accurate product on the tensor cores (3xTF32 on
// Hopper's warpgroup MMA) and the TMA ring that feeds it, shared by
// gemm_tf32.cu (kernel B12's products and the fp32 GEMM of kernels B1, B2
// and B7), block.cu (kernel B10's fp32 products) and bbc_loss.cu (kernel
// B4's scores):
//
//     C = [res +] act(A . Bt^T + bias)
//
// Each operand x is split as hi = tf32(x) (rounded as `cvt.rna.tf32.f32`
// rounds) and lo = tf32(x - hi), and lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// (the small terms first) is accumulated in fp32 by
// `wgmma.mma_async.m64nBNk8.f32.tf32.tf32`; the dropped lo_a.lo_b is ~2^-22
// of a product, so the sums keep fp32 accuracy (one tf32 pass keeps
// about three decimal digits). The tensor cores do not round their fp32
// accumulation to nearest: summed into one accumulator over K = 3,072
// (1,152 wgmmas), the products of B2's c_proj drifted by up to 5.6e-5 on
// an H100, past the fp32 tolerance of 2e-5. So with FOLD (the fp32 GEMM,
// B4, B10) each K tile's twelve wgmmas start a fresh partial accumulator
// (scale-d 0 on the first), and the partial is added into the output's
// accumulator on the CUDA cores (round to nearest) once the tile is
// multiplied; the next tile's wgmmas then wait for that add, which costs
// ~5% at B12's shapes. Without FOLD (B12, whose products feed an
// L2-normalized row, bits as in its first version) every wgmma adds into
// the output's accumulator and one K tile's wgmmas stay in flight while
// the next is issued.
//
// Layouts: A [M, K] and Bt [N, K] row-major (the activations and the torch
// Linear weight), both K-major as `wgmma` reads tf32. A K tile is 32 fp32
// (128 bytes) of each row, rows 128 bytes apart in the 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8)) that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and the `wgmma` descriptors' layout
// type 1 reads. A k8 tf32 step spans the 32 bytes of a k16 bf16 step, so
// the B descriptors are the bf16 GEMM's (`gemm_wgmma.cuh`).
//
// A block tile is 128 rows (two consumer warpgroups of 64) by BN = 32, 64
// or 128 columns. Per K tile, B (the weight tile) is split into an operand
// buffer (hi, then lo, in the same swizzle) by all 256 consumer threads
// with 16-byte shared loads and stores; A goes from the raw tile straight
// into registers, each warpgroup its own 64 rows in the wgmma register
// fragment, and is split there (the three products read B three times,
// so only B pays the split's shared-memory traffic). The bits of an
// output depend only on the sequence of its K tiles and k8 steps (every
// K tile the same three wgmmas a k8 step, ascending, into fp32
// accumulators that start at zero; K tiles past K zero-filled): not on
// BN or on the ring's depth. So B10, which runs this body on its own
// tiles, stays bit for bit equal to B1 + B2.
//
// Rules ptxas enforces (else it serializes every wgmma of the kernel,
// warning C7520): the A fragments are pinned before `wgmma.fence`
// (`fence_a`), and every warpgroup issues its wgmmas, also where its 64
// rows all lie past M (zeros from the fill): no branch around them.
#pragma once

#include <stdint.h>

#include "gemm_wgmma.cuh"
#include "tma.cuh"

namespace fern {

constexpr int kTfBM = 128, kTfBK = 32;          // a K tile: 32 fp32 = 128 bytes a row
constexpr int kTfTileABytes = kTfBM * kTfBK * 4;  // 16 KB: A's tile (and B's at BN = 128)

// Bytes of a B tile of bn rows (and of each half of its operand buffer).
__host__ __device__ constexpr int tf32_tile_b_bytes(int bn) { return bn * kTfBK * 4; }

// D[64, BN] = A[64, 8] . B[BN, 8]^T (+ D where scale_d is 1): A from
// registers (the fragment of `load_a`), B from shared memory.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void tf32_fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int N>
__device__ __forceinline__ void tf32_zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// acc += part, rounded to nearest on the CUDA cores, once the wgmmas
// that wrote `part` are complete.
template <int N>
__device__ __forceinline__ void tf32_fold(float (&acc)[N], float (&part)[N]) {
  tf32_fence_acc(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
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

// Loads this thread's A fragments of a K tile from the swizzled tile and
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

// Splits a raw B tile of BN rows into an operand buffer: hi at the same
// offset, lo one tile further. t: the consumer thread, 0..255.
template <int BN>
__device__ __forceinline__ void split_b(const unsigned char* b_tile, unsigned char* operands,
                                        int t) {
  constexpr int kBytes = tf32_tile_b_bytes(BN);
  static_assert(kBytes % (16 * kConsumerThreads) == 0, "whole 16-byte chunks a thread");
  const uint4* raw = reinterpret_cast<const uint4*>(b_tile);
  uint4* hi = reinterpret_cast<uint4*>(operands);
  uint4* lo = reinterpret_cast<uint4*>(operands + kBytes);
#pragma unroll
  for (int i = 0; i < kBytes / 16 / kConsumerThreads; ++i) {
    const int c = t + i * kConsumerThreads;
    const uint4 v = raw[c];
    const uint4 h = make_uint4(tf32_rna(__uint_as_float(v.x)), tf32_rna(__uint_as_float(v.y)),
                               tf32_rna(__uint_as_float(v.z)), tf32_rna(__uint_as_float(v.w)));
    hi[c] = h;
    lo[c] = make_uint4(tf32_lo(__uint_as_float(v.x), h.x), tf32_lo(__uint_as_float(v.y), h.y),
                       tf32_lo(__uint_as_float(v.z), h.z), tf32_lo(__uint_as_float(v.w), h.w));
  }
}

// The K tile's wgmmas of one warpgroup into `d` (FRESH: overwritten, the
// first wgmma does not read it; else added to): lo_a.hi_b, hi_a.lo_b,
// hi_a.hi_b a k8 step, ascending. b_hi: the operand buffer's shared
// address. Issued after `wgmma_fence`, committed by the caller.
template <int BN, bool FRESH>
__device__ __forceinline__ void tf32_mma(float (&d)[BN / 2], const TfA& a, uint32_t b_hi) {
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk) {
    const uint64_t bh = wgmma_desc(b_hi + kk * 32);
    const uint64_t bl = wgmma_desc(b_hi + tf32_tile_b_bytes(BN) + kk * 32);
    wgmma_tf32<BN>(d, a.lo[kk], bh, FRESH && kk == 0 ? 0 : 1);
    wgmma_tf32<BN>(d, a.hi[kk], bl, 1);
    wgmma_tf32<BN>(d, a.hi[kk], bh, 1);
  }
}

// ---- the TMA ring (gemm_tf32.cu, bbc_loss.cu, block.cu) ---------------------

// A ring of STAGES raw (A, B) K tiles, two operand buffers and the
// stages' mbarriers of a block tile 128 x BN. The block is the two
// consumer warpgroups alone (256 threads: two warps an SM quadrant, so
// up to 255 registers a thread, where a ninth, producer warp would cap
// them at 168); thread 0 issues every TMA copy.
template <int BN, int STAGES>
struct TfRing {
  static constexpr int kStageBytes = kTfTileABytes + tf32_tile_b_bytes(BN);
  static constexpr int kOperandBytes = 2 * tf32_tile_b_bytes(BN);
  static constexpr size_t kRing = (size_t)STAGES * kStageBytes;
  // alignment slack, the ring, two operand buffers, a "full" mbarrier a stage
  static constexpr size_t kSmem = 1024 + kRing + 2 * kOperandBytes + STAGES * sizeof(uint64_t);
};

constexpr int kTfThreads = kConsumerThreads;
constexpr int kTfStages = 5;  // the ring's depth: raw (A, B) K tiles

// Thread 0: the copies of K tile j (of the block's sequence) into its
// stage, completing the stage's mbarrier. load(j, dst, bar) issues them.
template <int BN, int STAGES, class Load>
__device__ __forceinline__ void tf32_issue(int j, unsigned char* smem, uint32_t full,
                                           const Load& load) {
  const int s = j % STAGES;
  const uint32_t bar = full + s * sizeof(uint64_t);
  mbar_expect_tx(bar, TfRing<BN, STAGES>::kStageBytes);
  load(j, smem_addr(smem + (size_t)s * TfRing<BN, STAGES>::kStageBytes), bar);
}

// The ring's start: thread 0 sets up the stages' mbarriers and issues the
// first min(STAGES, total) K tiles; every thread returns after the setup.
template <int BN, int STAGES, class Load>
__device__ __forceinline__ void tf32_ring_start(int total, unsigned char* smem, uint32_t full,
                                                const Load& load) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s * sizeof(uint64_t), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < STAGES && j < total; ++j) tf32_issue<BN, STAGES>(j, smem, full, load);
  }
  __syncthreads();
}

// One K tile, ring index i of the block's `total`: wait for its stage,
// split B into operand buffer i % 2, load and split A into `a`; once
// every thread has read the stage, thread 0 refills it with K tile
// i + STAGES. FOLD: wait for the K tile before (whose wgmmas ran while
// this one was split), fold its partial into `acc`, and issue this
// tile's wgmmas into `part`, left in flight. Else: issue this tile's
// wgmmas into `acc`, then wait for the tile before (`part` unused).
template <int BN, int STAGES, bool FOLD, class Load>
__device__ __forceinline__ void tf32_ktile(float (&acc)[BN / 2], float (&part)[BN / 2],
                                           TfA& a, int i, int total, unsigned char* smem,
                                           unsigned char* operands, uint32_t full,
                                           const Load& load) {
  using Ring = TfRing<BN, STAGES>;
  const int s = i % STAGES, wg = threadIdx.x / 128;
  unsigned char* stage = smem + (size_t)s * Ring::kStageBytes;
  unsigned char* ops = operands + (i % 2) * Ring::kOperandBytes;
  mbar_wait(full + s * sizeof(uint64_t), (i / STAGES) & 1);
  // both warpgroups are past their wait for the K tile two back, whose
  // wgmmas read this operand buffer
  named_barrier(1, kConsumerThreads);
  split_b<BN>(stage + kTfTileABytes, ops, threadIdx.x);
  load_a(a, stage + wg * kWgRows * 128, threadIdx.x % 128);
  fence_a(a);
  // the split's generic-proxy writes become visible to wgmma's reads, and
  // the stage's reads are ordered before the async-proxy refill
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2, kConsumerThreads);
  if (threadIdx.x == 0 && i + STAGES < total)
    tf32_issue<BN, STAGES>(i + STAGES, smem, full, load);
  if constexpr (FOLD) {
    wgmma_wait<0>();  // the K tile before this one is multiplied
    tf32_fold(acc, part);
    tf32_fence_acc(part);
    wgmma_fence();
    tf32_mma<BN, true>(part, a, smem_addr(ops));
    wgmma_commit();
  } else {
    tf32_fence_acc(acc);
    wgmma_fence();
    tf32_mma<BN, false>(acc, a, smem_addr(ops));
    wgmma_commit();
    wgmma_wait<1>();  // the K tile before this one is multiplied
    tf32_fence_acc(acc);
  }
}

// The K tiles [i0, i0 + count) of the block's ring sequence of `total`
// into `acc` (zeroed first), all multiplied (and folded) when it returns.
// The A register sets alternate by K tile: the wgmmas of one may still
// read its set while the next loads the other.
template <int BN, int STAGES, bool FOLD, class Load>
__device__ __forceinline__ void tf32_ktiles(float (&acc)[BN / 2], int i0, int count, int total,
                                            unsigned char* smem, unsigned char* operands,
                                            uint32_t full, const Load& load) {
  tf32_zero_acc(acc);
  TfA a0, a1;
  const auto run = [&](float (&part)[BN / 2]) {
    int i = 0;
    for (; i + 1 < count; i += 2) {
      tf32_ktile<BN, STAGES, FOLD>(acc, part, a0, i0 + i, total, smem, operands, full, load);
      tf32_ktile<BN, STAGES, FOLD>(acc, part, a1, i0 + i + 1, total, smem, operands, full, load);
    }
    if (i < count)
      tf32_ktile<BN, STAGES, FOLD>(acc, part, a0, i0 + i, total, smem, operands, full, load);
    wgmma_wait<0>();
  };
  if constexpr (FOLD) {
    float part[BN / 2];
    tf32_zero_acc(part);  // the first fold adds zeros
    run(part);
    tf32_fold(acc, part);
  } else {
    run(acc);
    tf32_fence_acc(acc);
  }
}

// ---- the epilogue ---------------------------------------------------------

// One output: bias added to the accumulator, the activation, then the
// residual, each add an explicit intrinsic (no contraction into an FMA),
// so every kernel on this body rounds the same way.
template <int ACT>
__device__ __forceinline__ float tf32_out(float acc, float bias, const float* res) {
  float v = apply_act(__fadd_rn(acc, bias), ACT);
  return res == nullptr ? v : __fadd_rn(*res, v);
}

// A warpgroup's [64, BN] accumulators into C at rows row0.., columns
// bn..: C[r, c] = [res[r, c] +] act(acc + bias[c]) (res at row stride N,
// C at ldc, even). Fragment of m64nNk8: warp w holds rows 16w.., lane l
// rows l/4 and l/4 + 8, columns 8j + 2(l%4) and the next of each n8
// block j. t: the thread in its warpgroup.
template <int BN, int ACT>
__device__ __forceinline__ void tf32_epilogue(const float (&acc)[BN / 2],
                                              const float* __restrict__ bias,
                                              const float* __restrict__ res,
                                              float* __restrict__ C, int M, int N, int ldc,
                                              int row0, int bn, int t) {
  const int r = row0 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = bn + 8 * j + 2 * (t % 4);
    if (col >= N) continue;  // N % 8 == 0: the pair is in or out
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M) continue;
      const float* rr = res != nullptr ? res + (size_t)row * N + col : nullptr;
      const float2 v = make_float2(tf32_out<ACT>(acc[4 * j + 2 * h], b0, rr),
                                   tf32_out<ACT>(acc[4 * j + 2 * h + 1], b1,
                                                 rr != nullptr ? rr + 1 : nullptr));
      *reinterpret_cast<float2*>(C + (size_t)row * ldc + col) = v;
    }
  }
}

// `tf32_epilogue` with a run-time activation code: one instance a code,
// so that each stays a constant inside the unrolled body.
template <int BN>
__device__ __forceinline__ void tf32_epilogue_act(const float (&acc)[BN / 2], const float* bias,
                                                  const float* res, float* C, int M, int N,
                                                  int ldc, int act, int row0, int bn, int t) {
  switch (act) {
    case ACT_QUICK_GELU:
      tf32_epilogue<BN, ACT_QUICK_GELU>(acc, bias, res, C, M, N, ldc, row0, bn, t);
      break;
    case ACT_GELU:
      tf32_epilogue<BN, ACT_GELU>(acc, bias, res, C, M, N, ldc, row0, bn, t);
      break;
    case ACT_RELU:
      tf32_epilogue<BN, ACT_RELU>(acc, bias, res, C, M, N, ldc, row0, bn, t);
      break;
    default:
      tf32_epilogue<BN, ACT_NONE>(acc, bias, res, C, M, N, ldc, row0, bn, t);
  }
}

}  // namespace fern
