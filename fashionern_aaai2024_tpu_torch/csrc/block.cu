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
// `gemm_tile.cuh`, `attention_core.cuh`), so its results are B1 + B2's
// bit for bit. The intermediates (LN rows, qkv, the attention output,
// y, the [B*S, F] hidden) go through a workspace the wrapper allocates;
// at a query's sizes it stays in the 50 MB L2. The grid barrier is the
// algorithm of cooperative_groups' grid sync on one word the wrapper
// keeps per (device, stream): each barrier flips its top bit and leaves
// the low bits as they were, so it never needs resetting.

#include <mutex>
#include <vector>

#include "attention_core.cuh"
#include "gemm_tile.cuh"
#include "layernorm_row.cuh"

namespace fern {

constexpr int kBlockHeadDim = 64;

template <typename T>
struct BlockArgs {
  const T *x, *ln1_w, *ln1_b, *in_w, *in_b, *out_w, *out_b;
  const T *ln2_w, *ln2_b, *fc_w, *fc_b, *proj_w, *proj_b;
  T *ln, *qkv, *attn, *y, *hidden, *out;  // workspace (qkv and hidden share) and output
  unsigned* barrier;
  int batch, seq, width, ffn, heads, row_tile, causal, act;
  int stage;  // bf16: the attention body's staging width of qkv
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
__device__ __forceinline__ void block_gemm(unsigned char* smem, const bf16* A, const bf16* Bt,
                                           const bf16* bias, const bf16* res, bf16* C, int M,
                                           int N, int K, int act) {
  Bf16TileSmem& sm = *reinterpret_cast<Bf16TileSmem*>(smem);
  const int tn = (N + kBN - 1) / kBN, tiles = tn * ((M + kBM - 1) / kBM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_bf16_tile(sm, A, Bt, bias, res, C, M, N, K, N, act, (t / tn) * kBM, (t % tn) * kBN);
}

__device__ __forceinline__ void block_gemm(unsigned char* smem, const float* A,
                                           const float* Bt, const float* bias,
                                           const float* res, float* C, int M, int N, int K,
                                           int act) {
  F32TileSmem& sm = *reinterpret_cast<F32TileSmem*>(smem);
  const int tn = (N + kFBN - 1) / kFBN, tiles = tn * ((M + kFBM - 1) / kFBM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_f32_tile(sm, A, Bt, bias, res, C, M, N, K, N, act, (t / tn) * kFBM, (t % tn) * kFBN,
                  0, K);
}

template <typename T>
__device__ __forceinline__ void block_layernorm(const T* x, const T* g, const T* b, T* y,
                                                int rows, int width, float eps) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32;
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < rows; r += gridDim.x * kWarps)
    layernorm_row(x + (size_t)r * width, g, b, y + (size_t)r * width, width, eps, lane);
}

// The arguments travel by value in one struct: no pointer here is a
// `const __restrict__` kernel parameter, so no load of an intermediate
// that another block wrote goes through the read-only cache.
template <typename T>
__global__ void __launch_bounds__(kThreads) block_kernel(const BlockArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.batch * a.seq, W = a.width;

  block_layernorm(a.x, a.ln1_w, a.ln1_b, a.ln, M, W, a.eps);
  grid_barrier(a.barrier);
  block_gemm(smem, a.ln, a.in_w, a.in_b, static_cast<const T*>(nullptr), a.qkv, M, 3 * W, W,
             ACT_NONE);
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
      attention_rows<T, T, kBlockHeadDim, false>(
          smem, a.qkv, a.qkv + W, a.qkv + 2 * W, nullptr, a.attn, bh / a.heads, bh % a.heads,
          row0, row1, a.seq, a.seq, a.heads, 3 * W, 3 * W, a.causal, a.scale);
  }
  grid_barrier(a.barrier);
  block_gemm(smem, a.attn, a.out_w, a.out_b, a.x, a.y, M, W, W, ACT_NONE);
  grid_barrier(a.barrier);
  block_layernorm(a.y, a.ln2_w, a.ln2_b, a.ln, M, W, a.eps);
  grid_barrier(a.barrier);
  block_gemm(smem, a.ln, a.fc_w, a.fc_b, static_cast<const T*>(nullptr), a.hidden, M, a.ffn, W,
             a.act);
  grid_barrier(a.barrier);
  block_gemm(smem, a.hidden, a.proj_w, a.proj_b, a.y, a.out, M, W, a.ffn, ACT_NONE);
}

template <typename T>
static size_t block_smem_bytes(int seq) {
  const size_t tile = sizeof(T) == 2 ? sizeof(Bf16TileSmem) : sizeof(F32TileSmem);
  const size_t attn = sizeof(T) == 2
                          ? attention_mma_smem_bytes<kBlockHeadDim>(seq, kThreads / 32)
                          : attention_smem_bytes<float, kBlockHeadDim>(seq);
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
  const int bm = sizeof(T) == 2 ? kBM : kFBM, bn = sizeof(T) == 2 ? kBN : kFBN;
  const int row_tiles = (M + bm - 1) / bm;
  const int wide = a.ffn > 3 * a.width ? a.ffn : 3 * a.width;
  // attention units: split each (sequence, head) into row tiles when there
  // are fewer pairs than blocks, of a multiple of the body's rows a warp
  // pass (bf16: a 16-row warp tile; fp32: a row for each of its warps)
  const int pairs = a.batch * a.heads;
  const int per_pair = (resident + pairs - 1) / pairs;
  const int quantum = sizeof(T) == 2 ? kMmaRows : kAttnWarps;
  int row_tile = (a.seq + per_pair - 1) / per_pair;
  row_tile = (row_tile + quantum - 1) / quantum * quantum;
  a.row_tile = row_tile < a.seq ? row_tile : a.seq;
  const int units[] = {(M + kThreads / 32 - 1) / (kThreads / 32),
                       row_tiles * ((wide + bn - 1) / bn),
                       pairs * ((a.seq + a.row_tile - 1) / a.row_tile)};
  int grid = 1;
  for (int u : units) grid = u > grid ? u : grid;
  grid = grid < resident ? grid : resident;
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
  a.stage = staging_width({a.qkv}, {3LL * width, kBlockHeadDim});
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
  cudaError_t err = cudaSetDevice(device);
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
