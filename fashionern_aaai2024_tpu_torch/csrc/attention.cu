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
// work); in fp32 the 3xTF32 products are three tf32 passes of 4 Sq Sk D
// FLOP a head (ViT-B-16 B = 32: 3.8 GFLOP, 0.023 ms at 495 / 3 TFLOP/s,
// as long as its 77.5 MB take at 3.35 TB/s).
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
// training): the same tiling on the tensor cores by 3xTF32 `mma.sync`
// (attention_tf32.cuh: tf32 m16n8k8 tiles, each product as lo.hi + hi.lo
// + hi.hi of its operands' tf32 split, every partial folded into the fp32
// sum on the CUDA cores). Blocks of up to 8 warps, a 16-row tile each, the
// tiles of a pair interleaved over blocks as in bf16; where the pairs
// leave SMs idle the tiles spread over more blocks, down to one warp each
// (B7 at b = 1: 8 heads x 6 tiles make 48 one-warp blocks, where one
// block a head ran before). K and V of the head go to shared memory raw
// by `cp.async` (16-byte copies where the pointers and strides allow,
// else 4-byte), K rows at D + 8 words and V rows at D + 4 so that the
// fragment loads are conflict-free, and are split into tf32 hi and lo as
// fragments are loaded. S runs one k-step at a time over all the keys (a
// lane holds one step's split query fragment), the softmax stays fp32 on
// the CUDA cores, and P goes from the accumulators into P . V through a
// permutation of the key order (no shuffle). One instance per count of
// 32-key groups (1 .. 8), compiled per head dim in attention_fp32_d64.cu
// and attention_fp32_d80.cu (attention_fp32.cuh).
//
// Rounding follows the Pallas kernels in both: fp32 scores and softmax,
// probabilities normalized in fp32 and cast to the storage type, P . V
// accumulated in fp32, output cast per head. The fp32 instance's products
// are 3xTF32, which agree with fp32 products to within the fp32 tolerance
// (2e-5), not bit for bit.

// The bodies are in attention_core.cuh: kernel B10 (block.cu) runs them
// too.

#include "attention_bf16.cuh"
#include "attention_fp32.cuh"

namespace fern {

template <int D>
static cudaError_t dispatch_types(const void* q, const void* k, const void* v,
                                  const float* bias, void* out, int batch, int sq, int sk,
                                  int heads, int q_ld, int kv_ld, int causal, float scale,
                                  int dtype, int out_dtype, int gb, int sms, cudaStream_t s) {
  if (dtype == DTYPE_BF16 && (out_dtype == DTYPE_BF16 || out_dtype == DTYPE_F32))
    return (D == 64 ? launch_attention_bf16_d64 : launch_attention_bf16_d80)(
        q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld, causal, scale, out_dtype, gb, s);
  if (dtype == DTYPE_F32 && out_dtype == DTYPE_F32)
    return (D == 64 ? launch_attention_fp32_d64 : launch_attention_fp32_d80)(
        q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld, causal, scale, gb, sms, s);
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
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int gb = images_per_block;
  if (sk < 1 || sk > fern::kMaxSeq || (causal && sq != sk) || gb < 1 || batch % gb)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int sms = fern::sm_count(device);
  if (head_dim == 64)
    return (int)fern::dispatch_types<64>(q, k, v, b, out, batch, sq, sk, heads, q_ld, kv_ld,
                                         causal, scale, dtype, out_dtype, gb, sms, s);
  if (head_dim == 80)
    return (int)fern::dispatch_types<80>(q, k, v, b, out, batch, sq, sk, heads, q_ld, kv_ld,
                                         causal, scale, dtype, out_dtype, gb, sms, s);
  return (int)cudaErrorInvalidValue;
}
