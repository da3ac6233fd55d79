// The attention core's bf16-operand kernel (attention.cu's design notes,
// "Design, bf16"): its template, launch and dispatch. Instantiated per
// head dim in attention_bf16_d64.cu and attention_bf16_d80.cu, which
// compile in parallel nvcc processes; attention.cu calls their entry
// points.
#pragma once

#include "attention_core.cuh"

namespace fern {

constexpr int kMmaWarps = 4;

// q, k, v as fern_attention takes them (bf16); out bf16 or fp32
// (out_dtype); Sk <= kMaxSeq.
cudaError_t launch_attention_bf16_d64(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int batch, int sq, int sk,
                                      int heads, int q_ld, int kv_ld, int causal, float scale,
                                      int out_dtype, int gb, cudaStream_t stream);
cudaError_t launch_attention_bf16_d80(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int batch, int sq, int sk,
                                      int heads, int q_ld, int kv_ld, int causal, float scale,
                                      int out_dtype, int gb, cudaStream_t stream);

// Block (x, h, z) runs tiles x, x + gridDim.x, ... of head h of images
// z*gb .. z*gb+gb-1 in turn; NP: the key pairs Sk needs.
template <typename TO, int D, bool kBias, int NP>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     TO* __restrict__ out, int Sq, int Sk, int H, int q_ld, int kv_ld,
                     int causal, float scale, int gb, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = 0; i < gb; ++i)
    attention_tiles_mma<TO, D, kBias, NP, true>(smem, q, k, v, bias, out, blockIdx.z * gb + i,
                                                blockIdx.y, kMmaRows * blockIdx.x,
                                                kMmaRows * gridDim.x, Sq, Sq, Sk, H, q_ld,
                                                kv_ld, causal, scale, width);
}

// Blocks of up to kMmaWarps warps, one 16-row tile each, the tiles of a
// (head, image) pair interleaved over `per_pair` blocks.
template <typename TO, int D, bool kBias, int NP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       void* out, int batch, int sq, int sk, int heads, int q_ld, int kv_ld,
                       int causal, float scale, int gb, cudaStream_t stream) {
  const int tiles = (sq + kMmaRows - 1) / kMmaRows;
  const int per_pair = (tiles + kMmaWarps - 1) / kMmaWarps;
  const int warps = (tiles + per_pair - 1) / per_pair;
  const size_t smem = attention_mma_smem_bytes<D>(sk, warps);
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<TO, D, kBias, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int width = staging_width({q, k, v}, {q_ld, kv_ld, D});
  dim3 grid(per_pair, heads, batch / gb);
  attention_mma_kernel<TO, D, kBias, NP><<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<TO*>(out), sq, sk, heads, q_ld, kv_ld, causal, scale, gb, width);
  return cudaGetLastError();
}

// One instance per key-pair count: NP = ceil(Sk / 32), 1 .. 8.
template <typename TO, int D, bool kBias>
cudaError_t launch_mma_pairs(const void* q, const void* k, const void* v, const float* bias,
                             void* out, int batch, int sq, int sk, int heads, int q_ld,
                             int kv_ld, int causal, float scale, int gb, cudaStream_t stream) {
  static_assert(kMaxSeq == 8 * kKeyPair, "one instance per pair count up to kMaxSeq");
#define FERN_PAIRS(NP)                                                                     \
  case NP:                                                                                 \
    return launch_mma<TO, D, kBias, NP>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, \
                                        kv_ld, causal, scale, gb, stream);
  switch ((sk + kKeyPair - 1) / kKeyPair) {
    FERN_PAIRS(1) FERN_PAIRS(2) FERN_PAIRS(3) FERN_PAIRS(4)
    FERN_PAIRS(5) FERN_PAIRS(6) FERN_PAIRS(7) FERN_PAIRS(8)
  }
#undef FERN_PAIRS
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_attention_bf16(const void* q, const void* k, const void* v,
                                  const float* bias, void* out, int batch, int sq, int sk,
                                  int heads, int q_ld, int kv_ld, int causal, float scale,
                                  int out_dtype, int gb, cudaStream_t stream) {
  if (out_dtype == DTYPE_BF16 && bias == nullptr)
    return launch_mma_pairs<bf16, D, false>(q, k, v, bias, out, batch, sq, sk, heads, q_ld,
                                            kv_ld, causal, scale, gb, stream);
  if (out_dtype == DTYPE_BF16)
    return launch_mma_pairs<bf16, D, true>(q, k, v, bias, out, batch, sq, sk, heads, q_ld,
                                           kv_ld, causal, scale, gb, stream);
  if (bias == nullptr)
    return launch_mma_pairs<float, D, false>(q, k, v, bias, out, batch, sq, sk, heads, q_ld,
                                             kv_ld, causal, scale, gb, stream);
  return launch_mma_pairs<float, D, true>(q, k, v, bias, out, batch, sq, sk, heads, q_ld,
                                          kv_ld, causal, scale, gb, stream);
}

}  // namespace fern
