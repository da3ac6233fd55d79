// The one softmax attention core of the port: kernels B3, B7 (after its
// projection GEMM), B8 and B9, and the attention core of kernels B1 and
// B6.
//
// Replaces: `_packed_kernel` / `_packed_pallas`
// (fashionern_aaai2024_tpu/ops/attention.py:124-163), the per-head loop
// inside `_subblock_kernel` (ops/attention.py:496-510), the attention half
// of `_qkv_fused_kernel` (ops/attention.py:370-384) and
// `_packed_cross_kernel` / `_packed_cross_pallas` (ops/attention.py:240-283),
// and `_attn_kernel` / `_mha_pallas` (ops/attention.py:61-110), B9, at head
// dim 64 / 80 and Sk <= 256 (attention_grouped.cu takes its other shapes);
// and the attention experiment's `_packed_kernel` / `mha_packed`
// (benchmarks/attn_experiment.py:147-190, X2: gb images a block) and the
// attention of `_qkvattn_kernel` and `_attnblock_kernel` (X3, X4), each
// with a shared [S, S] bias.
//
// Layouts: q rows [B, Sq, *] with row stride q_ld, k and v rows
// [B, Sk, *] with row stride kv_ld, head h at columns h*D .. h*D+D-1 of
// each; out [B, Sq, H*D]. One kernel serves
//   packed qkv [B, S, 3W]:    q = qkv, k = qkv + W, v = qkv + 2W, both ld 3W
//                             (B3, B1's core, B6's core, B7's core);
//   q [B, Sq, W] + kv [B, Sk, 2W]: k = kv, v = kv + W, kv_ld 2W (B8);
//   [B, H, S, Dh] views of [B, S, H*Dh] rows: heads H, ld H*Dh; and
//   contiguous [B*H, S, Dh]: heads 1, ld Dh (B9).
// B9 and X2-X4 add an optional shared [Sq, Sk] fp32 bias (causal with
// Sq != Sk, padding masks), read into the scores after the scale, where
// `_attn_kernel` adds it. A block runs one head of `images_per_block`
// images in turn (1 but for X2's gb).
// The output is in the operand type or in fp32: kernel B6
// (`_qattn_kernel`, ops/qmlp.py:186-201) keeps the concatenated heads in
// fp32 before it quantizes them. Heads are sliced in the kernel, so the
// [B, H, S, D] layout is never built in device memory.
//
// Bound: at Sk <= 256 the scores of one head fit on chip, so DRAM traffic
// is only q, k, v in and out once. In bf16 that is the bound (ViT-B-16 at
// B = 32: 38.7 MB, 0.0116 ms at 3.35 TB/s, against 0.0039 ms of tensor-core
// work); in fp32 the limit is the rate of fp32 FMAs fed from shared
// memory (2 x Sq x Sk x D a head, twice).
//
// Design, bf16 operands (output bf16, or fp32 for B6): the tensor-core
// tiles of attention_mma.cuh. A block of up to kMmaWarps warps takes one
// head of `images_per_block` images and up to kMmaWarps 16-row tiles of
// its queries, interleaved (block x of a pair's bpp takes the tiles x,
// x + bpp, ...), so the blocks of a pair get tile counts within one of
// each other: grid (bpp, heads, images / gb). K and V of the head go to
// shared memory by 16-byte `cp.async` copies (4-byte, or element copies,
// when the pointers or strides do not allow 16; `staging_width`), 16-byte
// rows padded to D + 8 elements so `ldmatrix` is conflict-free. Each warp
// keeps its rows' scores in registers, takes the row max and sum over its
// quads, and feeds p / denom, rounded to bf16, from the accumulators
// straight into the P . V product. The kernel has one instance per count
// of 32-key pairs (1 .. 8), which scores exactly that many with no branch
// between them (causal rows score the pairs they need); its code is in
// attention_bf16.cuh, compiled per head dim in attention_bf16_d64.cu and
// attention_bf16_d80.cu.
// The attention pool (Sq = 1, 82 keys) gets blocks of one warp: staging
// its kv once is the work, and one 16-row tile is 96 mma instructions.
// Why `mma.sync` and not `wgmma` / TMA: every bf16 shape here is bound by
// bytes, and `wgmma`'s 64-row tiles would pad 197 rows to 256 and 77 to
// 128; see ROADMAP.
//
// Design, fp32 (the ERN towers' B7 / B8 / B9, the fp32 tiers, TME
// training; kept bit for bit): one block per (head, image), K
// and V of the head staged in shared memory (the K rows padded to an odd
// word stride, 65 / 81 words at D = 64 / 80, so that the 32 lanes reading
// 32 different rows hit 32 banks). One warp per query row: each lane
// scores up to 8 keys with q held in registers, the softmax reductions
// are warp shuffles, and each lane then owns pairs of output dims for the
// P . V sum, which runs over the keys in order.
//
// Rounding follows the Pallas kernels in both: fp32 scores and softmax,
// probabilities normalized in fp32 and cast to the storage type, fp32
// P . V, output cast per head.

// The bodies are in attention_core.cuh: kernel B10 (block.cu) runs them
// too.

#include "attention_bf16.cuh"
#include "attention_core.cuh"

namespace fern {

// fp32: block (h, y) runs head h of images y*gb .. y*gb+gb-1 in turn.
template <typename T, typename TO, int D, bool kBias>
__global__ void __launch_bounds__(kAttnWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, TO* __restrict__ out, int Sq, int Sk, int H,
                 int q_ld, int kv_ld, int causal, float scale, int gb) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = 0; i < gb; ++i)
    attention_rows<T, TO, D, kBias>(smem, q, k, v, bias, out, blockIdx.y * gb + i, blockIdx.x,
                                    0, Sq, Sq, Sk, H, q_ld, kv_ld, causal, scale);
}

template <typename T, typename TO, int D, bool kBias>
static cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                                 const float* bias, void* out, int batch, int sq, int sk,
                                 int heads, int q_ld, int kv_ld, int causal, float scale,
                                 int gb, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<T, D>(sk);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, TO, D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(heads, batch / gb);
  attention_kernel<T, TO, D, kBias><<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<TO*>(out), sq, sk, heads, q_ld, kv_ld, causal, scale, gb);
  return cudaGetLastError();
}

template <typename T, typename TO, int D>
static cudaError_t launch_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int batch, int sq, int sk,
                                    int heads, int q_ld, int kv_ld, int causal, float scale,
                                    int gb, cudaStream_t stream) {
  if (bias == nullptr)
    return launch_kernel<T, TO, D, false>(q, k, v, bias, out, batch, sq, sk, heads, q_ld,
                                          kv_ld, causal, scale, gb, stream);
  return launch_kernel<T, TO, D, true>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld,
                                       causal, scale, gb, stream);
}

template <int D>
static cudaError_t dispatch_types(const void* q, const void* k, const void* v,
                                  const float* bias, void* out, int batch, int sq, int sk,
                                  int heads, int q_ld, int kv_ld, int causal, float scale,
                                  int dtype, int out_dtype, int gb, cudaStream_t s) {
  if (dtype == DTYPE_BF16 && (out_dtype == DTYPE_BF16 || out_dtype == DTYPE_F32))
    return (D == 64 ? launch_attention_bf16_d64 : launch_attention_bf16_d80)(
        q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld, causal, scale, out_dtype, gb, s);
  if (dtype == DTYPE_F32 && out_dtype == DTYPE_F32)
    return launch_attention<float, float, D>(q, k, v, bias, out, batch, sq, sk, heads, q_ld,
                                             kv_ld, causal, scale, gb, s);
  return cudaErrorInvalidValue;
}

}  // namespace fern

// q, k, v: the first head's first row of each operand (k and v may point
// into one packed tensor); bias: null or a contiguous fp32 [sq, sk] added
// to every head's scores; q_ld / kv_ld: row strides in elements; dtype:
// the operands' type; out_dtype: the output's, the same or fp32;
// images_per_block: images a block runs in turn (X2's gb), dividing batch.
extern "C" int fern_attention(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int batch, int sq, int sk, int heads, int head_dim,
                              int q_ld, int kv_ld, int causal, float scale, int dtype,
                              int out_dtype, int images_per_block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int gb = images_per_block;
  if (sk < 1 || sk > fern::kMaxSeq || (causal && sq != sk) || gb < 1 || batch % gb)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (head_dim == 64)
    return (int)fern::dispatch_types<64>(q, k, v, b, out, batch, sq, sk, heads, q_ld, kv_ld,
                                         causal, scale, dtype, out_dtype, gb, s);
  if (head_dim == 80)
    return (int)fern::dispatch_types<80>(q, k, v, b, out, batch, sq, sk, heads, q_ld, kv_ld,
                                         causal, scale, dtype, out_dtype, gb, s);
  return (int)cudaErrorInvalidValue;
}
