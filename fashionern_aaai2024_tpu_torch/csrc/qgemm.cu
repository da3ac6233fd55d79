// int8 GEMM with a rescaling epilogue: the four int8 products of kernels
// B5 and B6.
//
// Replaces: the `dot_general(..., preferred_element_type=int32)` calls
// and the fp32 rescales of `_qmlp_kernel` (fashionern_aaai2024_tpu/ops/
// qmlp.py:65-77) and `_qattn_kernel` (`qmlp.py:179-184, 203-208`).
//
//   C[m, n] = [res[m, n] +] cast(act(sum_g float(A_g[m, :] . Bt_g[n, :])
//                                          * a_scale[m, g] * b_scale[n] + bias[n]))
//
// A int8 [M, K], Bt int8 [N, K] (the torch Linear layout, out x in), both
// contiguous, int32 sums on the tensor cores. K splits into `groups` equal
// column groups (B5's c_proj: one per hidden quantization group,
// `qmlp.py:63-78`), group g with its own row scale
// a_scale[m * a_scale_stride + g]; one group is a plain product.
// The epilogue, in the Pallas kernels' order, each step rounded on its
// own (`__fmul_rn`, `__fadd_rn`; no FMA contraction): each group's int32
// sum converted once (`__int2float_rn`), times the row scale, times the
// column scale, added to the earlier groups' fp32 sum in group order
// (`acc + o32 * hs * wps`, `qmlp.py:77`); then `+ bias[n]`; the
// activation; then stored fp32, or cast to the storage type T, and
// `res[m, n] +` in T (`x + proj.astype(x.dtype)`). int32 sums are exact,
// so with the identity activation C equals its plain version
// (`int8_product(a, bt) * a_s * b_s + bias`, ops/qmatmul.py) bit for bit.
//
// Bound: at the serve shapes the products are compute-bound on the int8
// tensor cores (1,979 TOPS dense on an H100 SXM): a 128 x 256 x 128 tile
// does 8.4 MOPS per 48 KB it loads. Int8 weights (4.7 MB at W = 768) do
// not fit in 227 KB of shared memory as the TPU kernel kept them in VMEM:
// they stream through shared memory tile by tile and stay hot in the
// 50 MB L2.
// Design: gemm.cu's structure on int8 operands. A block of 288 threads
// takes a 128 x BN output tile: one producer warp keeps a ring of (A, Bt)
// K tiles of 128 int8 (one 128-byte swizzle row) in flight with TMA
// (`tma.cuh TmaRing`, unsigned 8-bit tensor maps: a byte is a byte), and
// two consumer warpgroups of 64 rows each issue four
// `wgmma.mma_async.m64nNk32.s32.s8.s8` a K tile (N = 128, or 64 for the
// narrow tile) into int32 accumulators, keep one K tile's products in
// flight and release the stage before. A group's first K tile starts its
// sums afresh (scale-d 0); at a group's end the consumer folds its sums
// into an fp32 accumulator in registers beside the int32 one, so B5's
// groups take one launch and no fp32 partial goes through memory. The
// epilogue goes through the ring, turned into an fp32 scratch: bias and
// activation in the accumulators' fragment layout, then the cast and the
// residual 8 columns a thread with 16-byte loads and stores. Two tiles,
// two blocks an SM (one block's epilogue overlaps the other's products):
// 128 x 128 (three stages) with one group, and 128 x 64 (four stages),
// whose two accumulators (int32 and fp32) fit the 96 registers a thread
// of two blocks, with any number of groups. The host picks the width
// (`ops/common.py int8_tile`). In exploratory runs a 128 x 256 tile at
// one block an SM was slower than 128 x 128 at every product of B5 and
// B6 (K is 512-768 there: its epilogue overlaps nothing), and a grouped
// 128 x 128 tile at one block an SM slower than 128 x 64.

#include <mutex>

#include "gemm_wgmma.cuh"
#include "tma.cuh"

namespace fern {

constexpr int kQBK = 128;                        // K of a tile: 128 int8, one swizzle row
constexpr int kQTileABytes = kGemmBM * kQBK;     // 16 KB

// A block tile BN wide: NB wgmmas of kCols columns, kRegs int32 a thread each.
template <int BN>
struct QTile {
  static constexpr int kCols = BN < 128 ? BN : 128;
  static constexpr int NB = BN / kCols;
  static constexpr int kRegs = kCols / 2;
  static constexpr int kStageBytes = kQTileABytes + BN * kQBK;
  static constexpr int kScratchLd = BN + 8;  // fp32; rows 32 bytes apart mod 128: no conflicts
};

// D[64, 128] (+)= A[64, 32] . B[128, 32]^T, int8 from shared memory, int32
// sums; scale_d 0 starts D afresh.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64, 64] (+)= A[64, 32] . B[64, 32]^T, as above.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma.
template <int NB, int R>
__device__ __forceinline__ void fence_acc(int (&acc)[NB][R]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[nb][i])::"memory");
}

// One K tile of a warpgroup's slab: a_addr is the first of its 64 rows of
// A, b_addr the first of BN rows of Bt, both swizzled; k32 step kk starts
// 32 bytes further in the 128-byte row. `fresh`: the tile starts the
// sums afresh.
template <int BN>
__device__ __forceinline__ void qmma_ktile(int (&acc)[QTile<BN>::NB][QTile<BN>::kRegs],
                                           uint32_t a_addr, uint32_t b_addr, bool fresh) {
  using Tile = QTile<BN>;
#pragma unroll
  for (int kk = 0; kk < kQBK / 32; ++kk) {
    const uint64_t da = wgmma_desc(a_addr + kk * 32);
#pragma unroll
    for (int nb = 0; nb < Tile::NB; ++nb)
      wgmma_s8(acc[nb], da, wgmma_desc(b_addr + nb * Tile::kCols * 128 + kk * 32),
               fresh && kk == 0 ? 0 : 1);
  }
}

// A warpgroup's int32 sums of group g, rescaled (`__int2float_rn`, times
// the row scale, times the column scale), into `sum` (first group) or
// added to it. Thread t holds, of each n8 block j of wgmma nb, rows
// r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns 8j + 2 (t % 4) and
// the next (the accumulator fragment of m64nNk32).
template <int NB, int R>
__device__ __forceinline__ void fold_group(float (&sum)[NB][R], const int (&acc)[NB][R],
                                           const float* __restrict__ a_scale, int a_stride,
                                           int g, const float* __restrict__ b_scale, int M,
                                           int N, int row0, int col0, int t, bool first) {
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
  const int gm0 = row0 + r, gm1 = gm0 + 8;
  const float as0 = gm0 < M ? a_scale[(size_t)gm0 * a_stride + g] : 0.f;
  const float as1 = gm1 < M ? a_scale[(size_t)gm1 * a_stride + g] : 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int gn = col0 + nb * 2 * R + 8 * j + c;
      const float bs0 = gn < N ? b_scale[gn] : 0.f, bs1 = gn + 1 < N ? b_scale[gn + 1] : 0.f;
      const float as[4] = {as0, as0, as1, as1}, bs[4] = {bs0, bs1, bs0, bs1};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[nb][4 * j + e]), as[e]), bs[e]);
        sum[nb][4 * j + e] = first ? v : __fadd_rn(sum[nb][4 * j + e], v);
      }
    }
}

// Eight consecutive values of T as fp32 (16-byte loads when `vec`, else
// the first n one by one), and eight fp32 values stored as TO. Every index
// is a constant of the unrolled loops: the arrays stay in registers.
__device__ __forceinline__ void load8(const float* src, float* v, int n, bool vec) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) v[e] = src[e];
}
__device__ __forceinline__ void load8(const bf16* src, float* v, int n, bool vec) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = to_f(h[e]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) v[e] = to_f(src[e]);
}
__device__ __forceinline__ void store8(float* dst, const float* v, int n, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) dst[e] = v[e];
}
__device__ __forceinline__ void store8(bf16* dst, const float* v, int n, bool vec) {
  if (vec) {
    __align__(16) bf16 h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = from_f<bf16>(v[e]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) dst[e] = from_f<bf16>(v[e]);
}

// The epilogue of a warpgroup's slab: rows row0.. (64), columns bn.. (BN).
// `scr` is its [64, kScratchLd] fp32 scratch, `t` its thread index, `bar`
// a named barrier no other warpgroup uses. First, in the fragment layout,
// `+ bias` and the activation (a constant of the instance) into the
// scratch; then 8 consecutive columns of a row a thread: the cast to TO,
// `res +` in T, one store (16-byte vectors where N % 8 == 0 and C and res
// are 16-byte aligned). Every load of a batch goes ahead of its stores.
// Ends with the barrier: the scratch is free again when it returns.
template <int BN, int ACT, typename T, typename TO>
__device__ __forceinline__ void q_epilogue_act(
    float (&sum)[QTile<BN>::NB][QTile<BN>::kRegs], float* scr, int t, int bar,
    const T* __restrict__ bias, const T* __restrict__ res, TO* __restrict__ C, int M, int N,
    int row0, int bn) {
  using Tile = QTile<BN>;
  constexpr int kLd = Tile::kScratchLd, kChunks = BN / 8;
  constexpr int kIters = kWgRows * kChunks / 128, kBatch = 4;
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int nb = 0; nb < Tile::NB; ++nb)
#pragma unroll
    for (int j = 0; j < Tile::kRegs / 4; ++j) {
      const int col = nb * Tile::kCols + 8 * j + c, gn = bn + col;
      const float b0 = bias != nullptr && gn < N ? to_f(bias[gn]) : 0.f;
      const float b1 = bias != nullptr && gn + 1 < N ? to_f(bias[gn + 1]) : 0.f;
      const float* d = &sum[nb][4 * j];
      float v[4] = {d[0], d[1], d[2], d[3]};
      if (bias != nullptr) {
        v[0] = __fadd_rn(v[0], b0);
        v[1] = __fadd_rn(v[1], b1);
        v[2] = __fadd_rn(v[2], b0);
        v[3] = __fadd_rn(v[3], b1);
      }
      *reinterpret_cast<float2*>(&scr[r * kLd + col]) =
          make_float2(apply_act(v[0], ACT), apply_act(v[1], ACT));
      *reinterpret_cast<float2*>(&scr[(r + 8) * kLd + col]) =
          make_float2(apply_act(v[2], ACT), apply_act(v[3], ACT));
    }
  named_barrier(bar, 128);
  const bool vec = N % 8 == 0 && ((reinterpret_cast<uintptr_t>(C) |
                                    reinterpret_cast<uintptr_t>(res)) & 15) == 0;
#pragma unroll
  for (int i0 = 0; i0 < kIters; i0 += kBatch) {
    float v[kBatch][8], rs[kBatch][8];
    int gm[kBatch], gn[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = t + 128 * (i0 + u), lr = i / kChunks, lc = 8 * (i % kChunks);
      gm[u] = row0 + lr;
      gn[u] = bn + lc;
      load8(&scr[lr * kLd + lc], v[u], 8, true);
      if (res == nullptr || gm[u] >= M || gn[u] >= N) continue;
      load8(res + (size_t)gm[u] * N + gn[u], rs[u], min(8, N - gn[u]), vec);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (gm[u] >= M || gn[u] >= N) continue;
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = res == nullptr ? v[u][e] : to_f(from_f<TO>(__fadd_rn(rs[u][e],
                                                                      round_to<TO>(v[u][e]))));
      store8(C + (size_t)gm[u] * N + gn[u], out, min(8, N - gn[u]), vec);
    }
  }
  named_barrier(bar, 128);
}

template <int BN, typename T, typename TO>
__device__ __forceinline__ void q_epilogue(float (&sum)[QTile<BN>::NB][QTile<BN>::kRegs],
                                           float* scr, int t, int bar, const T* bias,
                                           const T* res, TO* C, int M, int N, int act,
                                           int row0, int bn) {
  switch (act) {
    case ACT_QUICK_GELU:
      q_epilogue_act<BN, ACT_QUICK_GELU>(sum, scr, t, bar, bias, res, C, M, N, row0, bn);
      break;
    case ACT_GELU:
      q_epilogue_act<BN, ACT_GELU>(sum, scr, t, bar, bias, res, C, M, N, row0, bn);
      break;
    case ACT_RELU:
      q_epilogue_act<BN, ACT_RELU>(sum, scr, t, bar, bias, res, C, M, N, row0, bn);
      break;
    default:
      q_epilogue_act<BN, ACT_NONE>(sum, scr, t, bar, bias, res, C, M, N, row0, bn);
  }
}

// Shared memory of a tile width and a ring depth.
template <int BN, int STAGES>
struct QConfig {
  static constexpr size_t kRing = (size_t)STAGES * QTile<BN>::kStageBytes;
  static constexpr size_t kScratch = (size_t)kGemmBM * QTile<BN>::kScratchLd * sizeof(float);
  static constexpr size_t kData = kRing > kScratch ? kRing : kScratch;
  static constexpr size_t kSmem = 1024 + kData + TmaRing<STAGES>::kBarBytes;
};

// The output tile at rows blockIdx.y * 128.., columns blockIdx.x * BN..;
// GROUPED: the instance takes several groups (an fp32 accumulator beside
// the int32 one).
template <int BN, int STAGES, int BLOCKS, bool GROUPED, typename T, typename TO>
__global__ void __launch_bounds__(kGemmThreads, BLOCKS)
qgemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             const float* __restrict__ a_scale, int a_stride, const float* __restrict__ b_scale,
             const T* __restrict__ bias, const T* __restrict__ res, TO* __restrict__ C, int M,
             int N, int K, int groups, int act) {
  using Tile = QTile<BN>;
  using Cfg = QConfig<BN, STAGES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const TmaRing<STAGES> ring{smem_addr(smem), smem_addr(smem + Cfg::kData), Tile::kStageBytes,
                             kQTileABytes};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bm = blockIdx.y * kGemmBM, bn = blockIdx.x * BN;
  const int kt_count = (K + kQBK - 1) / kQBK;
  if (threadIdx.x == 0) ring.init(kConsumerThreads / 32);
  __syncthreads();

  if (warp == kProducerWarp) {
    // the producer: one thread issues every copy; the warp keeps few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (lane == 0) ring.produce(&map_a, &map_b, kt_count, kQBK, bm, bn);
  } else {
    // two consumer warpgroups, 64 rows each
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, row0 = bm + wg * kWgRows;
    // K tiles a group: a whole group of 128-column tiles when there are
    // several (the host checks), else every tile
    const int kt_group = GROUPED && groups > 1 ? K / groups / kQBK : kt_count;
    int acc[Tile::NB][Tile::kRegs];
    float sum[Tile::NB][Tile::kRegs];
#pragma unroll
    for (int nb = 0; nb < Tile::NB; ++nb)
#pragma unroll
      for (int i = 0; i < Tile::kRegs; ++i) acc[nb][i] = 0;
    for (int kt = 0; kt < kt_count; ++kt) {
      const uint32_t a = ring.wait(kt);
      fence_acc(acc);
      wgmma_fence();
      qmma_ktile<BN>(acc, a + wg * kWgRows * 128, a + kQTileABytes, kt % kt_group == 0);
      wgmma_commit();
      wgmma_wait<1>();  // the K tile before this one is multiplied: release its stage
      fence_acc(acc);
      if (kt > 0) ring.release(kt - 1, lane);
      if (GROUPED && (kt + 1) % kt_group == 0) {
        // a group's last K tile: its sums join the fp32 accumulator
        wgmma_wait<0>();
        fence_acc(acc);
        const int g = kt / kt_group;
        fold_group(sum, acc, a_scale, a_stride, g, b_scale, M, N, row0, bn, t, g == 0);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (!GROUPED) fold_group(sum, acc, a_scale, a_stride, 0, b_scale, M, N, row0, bn, t, true);
    // every copy has landed and been read: the ring turns into the scratch
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(3, kConsumerThreads);
    q_epilogue<BN>(sum, reinterpret_cast<float*>(smem) + wg * kWgRows * Tile::kScratchLd, t,
                   1 + wg, bias, res, C, M, N, act, row0, bn);
  }
}

// The tensor map of a contiguous int8 [rows, k] matrix, read in boxes of
// box_rows x 128, in the 128-byte swizzle, zero past its edges.
static cudaError_t s8_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, k, kQBK, box_rows);
}

template <int BN, int STAGES, int BLOCKS, bool GROUPED, typename T, typename TO>
static cudaError_t launch_q(const void* a, const void* bt, const void* a_scale, int a_stride,
                            const void* b_scale, const void* bias, const void* res, void* c,
                            int m, int n, int k, int groups, int act, int device,
                            cudaStream_t stream) {
  using Cfg = QConfig<BN, STAGES>;
  auto* kernel = qgemm_kernel<BN, STAGES, BLOCKS, GROUPED, T, TO>;
  static std::mutex mu;
  static bool opted[kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kSmem);
      if (err != cudaSuccess) return err;
      opted[device] = true;
    }
  }
  CUtensorMap map_a, map_b;
  cudaError_t err = s8_map(&map_a, a, m, k, kGemmBM);
  if (err != cudaSuccess) return err;
  err = s8_map(&map_b, bt, n, k, BN);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, Cfg::kSmem, stream>>>(
      map_a, map_b, static_cast<const float*>(a_scale), a_stride,
      static_cast<const float*>(b_scale), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<TO*>(c), m, n, k, groups, act);
  return cudaGetLastError();
}

// The instance of a tile width: 128 (one group) or 64 (any groups).
template <typename T, typename TO>
static cudaError_t launch_tile(int tile, const void* a, const void* bt, const void* a_scale,
                               int a_stride, const void* b_scale, const void* bias,
                               const void* res, void* c, int m, int n, int k, int groups,
                               int act, int device, cudaStream_t s) {
  if (tile == 128 && groups == 1)
    return launch_q<128, 3, 2, false, T, TO>(a, bt, a_scale, a_stride, b_scale, bias, res, c,
                                             m, n, k, groups, act, device, s);
  if (tile == 64)
    return launch_q<64, 4, 2, true, T, TO>(a, bt, a_scale, a_stride, b_scale, bias, res, c, m,
                                           n, k, groups, act, device, s);
  return cudaErrorInvalidValue;
}

}  // namespace fern

// dtype: the type of bias and res; out_f32: C is fp32 rather than dtype
// (with bf16 bias, res must then be null). a and bt start on 16-byte
// boundaries (TMA's rule for a base address), both contiguous, with k a
// multiple of 16 (TMA's rule for a row stride, and the int8 k step);
// groups divides k and, when there are several, k / groups is a multiple
// of 128 (whole K tiles a group). a_scale holds group g of row r at r * a_scale_stride +
// g. tile: 128 (one group only) or 64, chosen by the host
// (`ops/common.py int8_tile`). Anything else is refused.
extern "C" int fern_qgemm(const void* a, const void* bt, const void* a_scale,
                          int a_scale_stride, const void* b_scale, const void* bias,
                          const void* res, void* c, int m, int n, int k, int groups, int act,
                          int dtype, int out_f32, int tile, int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(a) | reinterpret_cast<unsigned long long>(bt);
  if (k <= 0 || k % 16 || addr % 16 || groups < 1 || k % groups ||
      (groups > 1 && (k / groups) % fern::kQBK) ||
      (out_f32 && dtype == fern::DTYPE_BF16 && res != nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using fern::bf16;
  using fern::launch_tile;
  if (dtype == fern::DTYPE_BF16 && out_f32)
    return (int)launch_tile<bf16, float>(tile, a, bt, a_scale, a_scale_stride, b_scale, bias,
                                         res, c, m, n, k, groups, act, device, s);
  if (dtype == fern::DTYPE_BF16)
    return (int)launch_tile<bf16, bf16>(tile, a, bt, a_scale, a_scale_stride, b_scale, bias,
                                        res, c, m, n, k, groups, act, device, s);
  if (dtype == fern::DTYPE_F32)
    return (int)launch_tile<float, float>(tile, a, bt, a_scale, a_scale_stride, b_scale, bias,
                                          res, c, m, n, k, groups, act, device, s);
  return (int)cudaErrorInvalidValue;
}
