// Kernel B10: one whole pre-LN transformer block in one launch,
//
//     y = x + out_proj(attn(qkv(LN1(x))))
//     z = y + c_proj(act(c_fc(LN2(y))))
//
// for x [B, S, W] in bf16 or fp32, head dim 64, S <= 256, causal (the
// CLIP text towers) or not (the ViT trunk).
//
// Replaces: `_block_kernel` / `_block_pallas`
// (fashionern_aaai2024_tpu/ops/block.py:48-129), which ran both halves
// of a block in one Pallas program per group of sequences with all four
// weight matrices resident in VMEM.
//
// Bound: at a query's sizes (B*S = 77 or 2,464 rows) the work is small
// (24 W^2 FLOP a row plus attention; 6.3 MB of bf16 weights at W = 512)
// and the sub-block pair B1 + B2 pays for it in seven launches (LN, GEMM,
// core, GEMM; LN, GEMM, GEMM) whose host-side enqueue, not the card,
// sets the pace. At large B the products are compute-bound on the
// tensor cores, as in B1 / B2.
// Design: Hopper's 227 KB of shared memory cannot hold the weights, so
// the property that carries over is one launch per block. One persistent
// cooperative kernel (every block resident, `cudaLaunchCooperativeKernel`)
// runs seven phases separated by grid-wide barriers: LN1, QKV + bias,
// attention per (sequence, head, row tile), out-projection + bias +
// residual, LN2, c_fc + bias + activation, c_proj + bias + residual. Each
// phase walks its work units round-robin over the blocks, with the same
// device code as the sub-block kernels (`layernorm_row.cuh`,
// `gemm_wgmma.cuh` in bf16 and `gemm_tf32.cuh` in fp32,
// `attention_core.cuh`: bf16 or 3xTF32 `mma.sync` tiles), so its results
// are B1 + B2's bit for bit: a
// product's tiles run the GEMM's warpgroup-MMA body (the same `wgmma`
// instructions in the same k order). In bf16 the 128 x 128 tiles are
// staged by the block's 256 threads with cp.async into the swizzled
// layout TMA writes for gemm.cu; in fp32 they come through gemm_tf32.cu's
// own TMA ring (`tf32_ktiles`, tensor maps `launch_block` encodes),
// 128 x 32, 64 or 128 (the narrowest whose tiles the grid's blocks take
// in one round, as the bits do not depend on the width). The
// intermediates (LN rows, qkv, the attention output, y, the [B*S, F]
// hidden) go through a workspace the wrapper allocates;
// at a query's sizes it stays in the 50 MB L2. The grid barrier is the
// algorithm of cooperative_groups' grid sync on one word the wrapper
// keeps per (device, stream): each barrier flips its top bit and leaves
// the low bits as they were, so it never needs resetting.

#include <mutex>
#include <vector>

#include "attention_core.cuh"
#include "gemm_tf32.cuh"
#include "gemm_wgmma.cuh"
#include "layernorm_row.cuh"

namespace fern {

constexpr int kBlockHeadDim = 64;
constexpr int kThreads = kConsumerThreads;  // the GEMM tiles' two warpgroups
static_assert(kGemmBM == kTfBM, "both dtypes' GEMM tiles are 128 rows");

// fp32: the tensor maps of the four products' operands (QKV, out-projection,
// c_fc, c_proj: A, then B) and each product's output tile width.
struct F32Products {
  CUtensorMap a[4], b[4];
  int tile[4];
};

template <typename T>
struct BlockArgs {
  F32Products f32;  // fp32 only
  const T *x, *ln1_w, *ln1_b, *in_w, *in_b, *out_w, *out_b;
  const T *ln2_w, *ln2_b, *fc_w, *fc_b, *proj_w, *proj_b;
  T *ln, *qkv, *attn, *y, *hidden, *out;  // workspace (qkv and hidden share) and output
  unsigned* barrier;
  int batch, seq, width, ffn, heads, row_tile, causal, act;
  int stage;  // the attention body's staging width of qkv
  float scale, eps;
};

// A wait longer than this many SM clock cycles (~10 s) means some block
// never arrives: the kernel traps (a launch error) instead of hanging.
constexpr long long kBarrierTimeout = 1LL << 34;

// Every block waits here until all blocks have arrived; global writes
// made before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned nb = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(arrived, nb);
    const long long start = clock64();
    while (((old ^ *reinterpret_cast<volatile unsigned*>(arrived)) & 0x80000000u) == 0) {
      if (clock64() - start > kBarrierTimeout) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// One product of the block, its output tiles walked round-robin.
__device__ __forceinline__ void block_gemm(unsigned char* smem, const F32Products&, int,
                                           const bf16* A, const bf16* Bt, const bf16* bias,
                                           const bf16* res, bf16* C, int M, int N, int K,
                                           int act) {
  const int tn = (N + kMmaN - 1) / kMmaN, tiles = tn * ((M + kGemmBM - 1) / kGemmBM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_bf16_tile(smem, A, Bt, bias, res, C, M, N, K, N, act, (t / tn) * kGemmBM,
                   (t % tn) * kMmaN);
}

template <int BN>
__device__ __forceinline__ void block_gemm_tf32(unsigned char* smem_raw,
                                                const CUtensorMap* map_a,
                                                const CUtensorMap* map_b, const float* bias,
                                                const float* res, float* C, int M, int N,
                                                int K, int act) {
  using Ring = TfRing<BN, kTfStages>;
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* operands = smem + Ring::kRing;
  const uint32_t full = smem_addr(operands + 2 * Ring::kOperandBytes);
  const int tn = (N + BN - 1) / BN, tiles = tn * ((M + kTfBM - 1) / kTfBM);
  const int kt_count = (K + kTfBK - 1) / kTfBK;
  // the phase before wrote shared memory, and the blocks wrote this
  // product's A, through the generic proxy: both before TMA's reads
  asm volatile("fence.proxy.async;\n" ::: "memory");
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int bm = (t / tn) * kTfBM, bn = (t % tn) * BN;
    const auto load = [&](int j, uint32_t dst, uint32_t bar) {
      tma_load(map_a, dst, bar, j * kTfBK, bm);
      tma_load(map_b, dst + kTfTileABytes, bar, j * kTfBK, bn);
    };
    __syncthreads();  // every thread is past its last wait on the ring
    tf32_ring_start<BN, kTfStages>(kt_count, smem, full, load);
    float acc[BN / 2];
    tf32_ktiles<BN, kTfStages, true>(acc, 0, kt_count, kt_count, smem, operands, full, load);
    tf32_epilogue_act<BN>(acc, bias, res, C, M, N, N, act, bm + (threadIdx.x / 128) * kWgRows,
                          bn, threadIdx.x % 128);
  }
}

__device__ __forceinline__ void block_gemm(unsigned char* smem, const F32Products& f32, int p,
                                           const float*, const float*, const float* bias,
                                           const float* res, float* C, int M, int N, int K,
                                           int act) {
  switch (f32.tile[p]) {
    case 32:
      block_gemm_tf32<32>(smem, &f32.a[p], &f32.b[p], bias, res, C, M, N, K, act);
      break;
    case 64:
      block_gemm_tf32<64>(smem, &f32.a[p], &f32.b[p], bias, res, C, M, N, K, act);
      break;
    default:
      block_gemm_tf32<128>(smem, &f32.a[p], &f32.b[p], bias, res, C, M, N, K, act);
  }
}

// Kernel B11's row routine, chosen by the same rule (`layernorm_rows`),
// each warp walking rows with a grid stride.
template <typename T>
__device__ __forceinline__ void block_layernorm(const T* x, const T* g, const T* b, T* y,
                                                int rows, int width, float eps) {
  constexpr int kWarps = kThreads / 32;
  layernorm_rows(x, g, b, y, rows, width, eps, blockIdx.x * kWarps + threadIdx.x / 32,
                 gridDim.x * kWarps, threadIdx.x % 32);
}

// fp32: one attention unit of B10, out of line, at NP 32-key groups. The
// 3xTF32 body holds 4 NP scores a lane in registers; inlined at NP = 8,
// that pressure made ptxas spill 964 bytes across the whole kernel, its
// GEMM phases too. Out of line the kernel spills 20 bytes (`-Xptxas -v`),
// and each instance keeps its registers to itself (96 bytes of spill
// stores at NP = 1, 224 at a text tower's 3, 544 at 8). NP is the count
// S needs, as the core's kernel takes it: a text tower's 77 keys hold 12
// scores a lane where NP = 8 held 32. The bits are the same at every NP
// (the same body, in the same order, each unit scoring only the groups
// its rows need), so B10 stays B1 + B2's.
template <int NP>
__device__ __noinline__ void block_attention_tf32_np(unsigned char* smem, const float* qkv,
                                                     float* attn, int b, int h, int row0,
                                                     int row1, int seq, int heads, int W,
                                                     int causal, float scale, int stage) {
  attention_tiles_tf32<kBlockHeadDim, false, NP, false>(
      smem, qkv, qkv + W, qkv + 2 * W, nullptr, attn, b, h, row0, kMmaRows, row1, seq, seq,
      heads, 3 * W, 3 * W, causal, scale, stage);
}

__device__ __forceinline__ void block_attention_tf32(unsigned char* smem, const float* qkv,
                                                     float* attn, int b, int h, int row0,
                                                     int row1, int seq, int heads, int W,
                                                     int causal, float scale, int stage) {
  static_assert(kMaxSeq == 8 * kTfKeyGroup, "one instance per group count up to kMaxSeq");
#define FERN_GROUPS(NP)                                                                     \
  case NP:                                                                                  \
    return block_attention_tf32_np<NP>(smem, qkv, attn, b, h, row0, row1, seq, heads, W,     \
                                       causal, scale, stage);
  switch ((seq + kTfKeyGroup - 1) / kTfKeyGroup) {
    FERN_GROUPS(1) FERN_GROUPS(2) FERN_GROUPS(3) FERN_GROUPS(4)
    FERN_GROUPS(5) FERN_GROUPS(6) FERN_GROUPS(7) FERN_GROUPS(8)
  }
#undef FERN_GROUPS
}

// The arguments travel by value in one struct: no pointer here is a
// `const __restrict__` kernel parameter, so no load of an intermediate
// that another block wrote goes through the read-only cache. The struct
// is a grid constant: TMA reads its tensor maps where they lie.
template <typename T>
__global__ void __launch_bounds__(kThreads) block_kernel(const __grid_constant__ BlockArgs<T> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int M = a.batch * a.seq, W = a.width;

  block_layernorm(a.x, a.ln1_w, a.ln1_b, a.ln, M, W, a.eps);
  grid_barrier(a.barrier);
  block_gemm(smem, a.f32, 0, a.ln, a.in_w, a.in_b, static_cast<const T*>(nullptr), a.qkv, M,
             3 * W, W, ACT_NONE);
  grid_barrier(a.barrier);
  const int tiles = (a.seq + a.row_tile - 1) / a.row_tile;
  const int units = a.batch * a.heads * tiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int bh = u / tiles, row0 = (u % tiles) * a.row_tile;
    const int row1 = min(a.seq, row0 + a.row_tile);
    if constexpr (sizeof(T) == 2)
      attention_tiles_mma<bf16, kBlockHeadDim, false, kMaxSeq / kKeyPair, false>(
          smem, a.qkv, a.qkv + W, a.qkv + 2 * W, nullptr, a.attn, bh / a.heads, bh % a.heads,
          row0, kMmaRows, row1, a.seq, a.seq, a.heads, 3 * W, 3 * W, a.causal, a.scale,
          a.stage);
    else
      block_attention_tf32(smem, a.qkv, a.attn, bh / a.heads, bh % a.heads, row0, row1, a.seq,
                           a.heads, W, a.causal, a.scale, a.stage);
  }
  grid_barrier(a.barrier);
  block_gemm(smem, a.f32, 1, a.attn, a.out_w, a.out_b, a.x, a.y, M, W, W, ACT_NONE);
  grid_barrier(a.barrier);
  block_layernorm(a.y, a.ln2_w, a.ln2_b, a.ln, M, W, a.eps);
  grid_barrier(a.barrier);
  block_gemm(smem, a.f32, 2, a.ln, a.fc_w, a.fc_b, static_cast<const T*>(nullptr), a.hidden, M,
             a.ffn, W, a.act);
  grid_barrier(a.barrier);
  block_gemm(smem, a.f32, 3, a.hidden, a.proj_w, a.proj_b, a.y, a.out, M, W, a.ffn, ACT_NONE);
}

template <typename T>
static size_t block_smem_bytes(int seq) {
  const size_t tile =
      sizeof(T) == 2 ? wgmma_tile_smem_bytes() : TfRing<kMmaN, kTfStages>::kSmem;
  const size_t attn = sizeof(T) == 2
                          ? attention_mma_smem_bytes<kBlockHeadDim>(seq, kThreads / 32)
                          : attention_tf32_smem_bytes<kBlockHeadDim>(seq, kThreads / 32);
  return tile > attn ? tile : attn;
}

// Co-resident blocks of block_kernel<T> at `smem` bytes on `device`,
// computed once per (device, dtype, smem) after the shared-memory opt-in.
template <typename T>
static cudaError_t resident_blocks(int device, size_t smem, int* blocks) {
  struct Entry { int device; size_t smem; int blocks; };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.device == device && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the opt-in is the largest any call needs: it bounds, not sets, a launch's smem
  err = cudaFuncSetAttribute(block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)block_smem_bytes<T>(kMaxSeq));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.push_back({device, smem, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_block(BlockArgs<T> a, int device, cudaStream_t stream) {
  const size_t smem = block_smem_bytes<T>(a.seq);
  int resident = 0;
  cudaError_t err = resident_blocks<T>(device, smem, &resident);
  if (err != cudaSuccess) return err;
  const int M = a.batch * a.seq;
  // 128-row tiles in both dtypes (kGemmBM == kTfBM); fp32's narrowest is
  // 32 columns wide
  const int row_tiles = (M + kGemmBM - 1) / kGemmBM;
  const int narrowest = sizeof(T) == 2 ? kMmaN : 32;
  const int wide = a.ffn > 3 * a.width ? a.ffn : 3 * a.width;
  // attention units: split each (sequence, head) into row tiles when there
  // are fewer pairs than blocks, of a multiple of the body's 16-row warp
  // tile
  const int pairs = a.batch * a.heads;
  const int per_pair = (resident + pairs - 1) / pairs;
  int row_tile = (a.seq + per_pair - 1) / per_pair;
  row_tile = (row_tile + kMmaRows - 1) / kMmaRows * kMmaRows;
  a.row_tile = row_tile < a.seq ? row_tile : a.seq;
  const int units[] = {(M + kThreads / 32 - 1) / (kThreads / 32),
                       row_tiles * ((wide + narrowest - 1) / narrowest),
                       pairs * ((a.seq + a.row_tile - 1) / a.row_tile)};
  int grid = 1;
  for (int u : units) grid = u > grid ? u : grid;
  grid = grid < resident ? grid : resident;
  if constexpr (sizeof(T) == 4) {
    // each product: the narrowest tile whose tiles the blocks take in one
    // round (else 128), and the tensor maps of A [M, K] and B [N, K]
    const int W = a.width, F = a.ffn;
    const void* A[4] = {a.ln, a.attn, a.ln, a.hidden};
    const void* Bt[4] = {a.in_w, a.out_w, a.fc_w, a.proj_w};
    const int N[4] = {3 * W, W, F, W}, K[4] = {W, W, W, F};
    for (int p = 0; p < 4; ++p) {
      int bn = 32;
      while (bn < 128 && row_tiles * ((N[p] + bn - 1) / bn) > grid) bn *= 2;
      a.f32.tile[p] = bn;
      err = tile_map(&a.f32.a[p], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), A[p], M, K[p],
                     kTfBK, kTfBM);
      if (err != cudaSuccess) return err;
      err = tile_map(&a.f32.b[p], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), Bt[p], N[p],
                     K[p], kTfBK, bn);
      if (err != cudaSuccess) return err;
    }
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)block_kernel<T>, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
static cudaError_t run_block(const void* const* w, void* workspace, void* barrier, void* out,
                             int batch, int seq, int width, int ffn, int heads, int causal,
                             float scale, float eps, int act, int device,
                             cudaStream_t stream) {
  BlockArgs<T> a;
  const T* const* p = reinterpret_cast<const T* const*>(w);
  a.x = p[0]; a.ln1_w = p[1]; a.ln1_b = p[2]; a.in_w = p[3]; a.in_b = p[4];
  a.out_w = p[5]; a.out_b = p[6]; a.ln2_w = p[7]; a.ln2_b = p[8]; a.fc_w = p[9];
  a.fc_b = p[10]; a.proj_w = p[11]; a.proj_b = p[12];
  const size_t rows = (size_t)batch * seq;
  const size_t wide = ffn > 3 * width ? ffn : 3 * width;
  T* ws = static_cast<T*>(workspace);
  a.ln = ws;
  a.qkv = a.hidden = ws + rows * width;
  a.attn = a.qkv + rows * wide;
  a.y = a.attn + rows * width;
  a.out = static_cast<T*>(out);
  a.barrier = static_cast<unsigned*>(barrier);
  a.batch = batch; a.seq = seq; a.width = width; a.ffn = ffn; a.heads = heads;
  a.row_tile = seq; a.causal = causal; a.act = act; a.scale = scale; a.eps = eps;
  a.stage = staging_width({a.qkv}, {3LL * width, kBlockHeadDim}, sizeof(T));
  return launch_block<T>(a, device, stream);
}

}  // namespace fern

// x and the twelve parameters in the torch layout (in_w [3W, W], out_w
// [W, W], fc_w [F, W], proj_w [W, F]), all of `dtype`, contiguous;
// workspace: B*S*(3W + max(3W, F)) elements of `dtype`; barrier: one
// 32-bit word used by no concurrent launch; out [B, S, W].
extern "C" int fern_block(const void* x, const void* ln1_w, const void* ln1_b,
                          const void* in_w, const void* in_b, const void* out_w,
                          const void* out_b, const void* ln2_w, const void* ln2_b,
                          const void* fc_w, const void* fc_b, const void* proj_w,
                          const void* proj_b, void* workspace, void* barrier, void* out,
                          int batch, int seq, int width, int ffn, int heads, int causal,
                          float scale, float eps, int act, int dtype, int device,
                          void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (width != heads * fern::kBlockHeadDim || seq < 1 || seq > fern::kMaxSeq || width % 8 ||
      ffn % 8 || ffn < 8)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const void* w[] = {x, ln1_w, ln1_b, in_w, in_b, out_w, out_b,
                     ln2_w, ln2_b, fc_w, fc_b, proj_w, proj_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16)
    return (int)fern::run_block<fern::bf16>(w, workspace, barrier, out, batch, seq, width, ffn,
                                            heads, causal, scale, eps, act, device, s);
  if (dtype == fern::DTYPE_F32)
    return (int)fern::run_block<float>(w, workspace, barrier, out, batch, seq, width, ffn,
                                       heads, causal, scale, eps, act, device, s);
  return (int)cudaErrorInvalidValue;
}
