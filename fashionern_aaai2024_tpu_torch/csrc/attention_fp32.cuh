// The attention core's fp32 kernel (attention.cu's design notes, "Design,
// fp32"): its template, launch and dispatch. Instantiated per head dim in
// attention_fp32_d64.cu and attention_fp32_d80.cu, which compile in
// parallel nvcc processes; attention.cu calls their entry points.
#pragma once

#include "attention_core.cuh"

namespace fern {

constexpr int kTf32Warps = 8;

// q, k, v as fern_attention takes them (fp32); out fp32; Sk <= kMaxSeq;
// sms: the card's SM count.
cudaError_t launch_attention_fp32_d64(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int batch, int sq, int sk,
                                      int heads, int q_ld, int kv_ld, int causal, float scale,
                                      int gb, int sms, cudaStream_t stream);
cudaError_t launch_attention_fp32_d80(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int batch, int sq, int sk,
                                      int heads, int q_ld, int kv_ld, int causal, float scale,
                                      int gb, int sms, cudaStream_t stream);

// Block (x, h, z) runs tiles x, x + gridDim.x, ... of head h of images
// z*gb .. z*gb+gb-1 in turn; NP: the 32-key groups Sk needs.
template <int D, bool kBias, int NP>
__global__ void __launch_bounds__(kTf32Warps * 32)
attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, int Sq, int Sk, int H, int q_ld, int kv_ld,
                      int causal, float scale, int gb, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = 0; i < gb; ++i)
    attention_tiles_tf32<D, kBias, NP, true>(smem, q, k, v, bias, out, blockIdx.z * gb + i,
                                             blockIdx.y, kMmaRows * blockIdx.x,
                                             kMmaRows * gridDim.x, Sq, Sq, Sk, H, q_ld, kv_ld,
                                             causal, scale, width);
}

// Blocks of up to kTf32Warps warps, one 16-row tile each, the tiles of a
// (head, image) pair interleaved over `per_pair` blocks. When the pairs
// alone leave SMs idle (B7 at b = 1: 8 pairs of 6 tiles), the tiles
// spread over more blocks, down to one warp a block, until the blocks
// cover the SMs.
template <int D, bool kBias, int NP>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int batch, int sq, int sk, int heads, int q_ld, int kv_ld,
                        int causal, float scale, int gb, int sms, cudaStream_t stream) {
  const int tiles = (sq + kMmaRows - 1) / kMmaRows;
  const long long pairs = (long long)heads * (batch / gb);
  int per_pair = (tiles + kTf32Warps - 1) / kTf32Warps;
  const long long spread = (sms + pairs - 1) / pairs;
  if (per_pair < spread) per_pair = spread < tiles ? (int)spread : tiles;
  const int warps = (tiles + per_pair - 1) / per_pair;
  const size_t smem = attention_tf32_smem_bytes<D>(sk, warps);
  cudaError_t err = cudaFuncSetAttribute(attention_tf32_kernel<D, kBias, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int width = staging_width({q, k, v}, {q_ld, kv_ld, D}, 4);
  dim3 grid(per_pair, heads, batch / gb);
  attention_tf32_kernel<D, kBias, NP><<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), sq, sk, heads, q_ld, kv_ld, causal, scale, gb, width);
  return cudaGetLastError();
}

// One instance per 32-key group count: NP = ceil(Sk / 32), 1 .. 8.
template <int D, bool kBias>
cudaError_t launch_tf32_groups(const void* q, const void* k, const void* v, const float* bias,
                               void* out, int batch, int sq, int sk, int heads, int q_ld,
                               int kv_ld, int causal, float scale, int gb, int sms,
                               cudaStream_t stream) {
  static_assert(kMaxSeq == 8 * kTfKeyGroup, "one instance per group count up to kMaxSeq");
#define FERN_GROUPS(NP)                                                                   \
  case NP:                                                                                \
    return launch_tf32<D, kBias, NP>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld, \
                                     causal, scale, gb, sms, stream);
  switch ((sk + kTfKeyGroup - 1) / kTfKeyGroup) {
    FERN_GROUPS(1) FERN_GROUPS(2) FERN_GROUPS(3) FERN_GROUPS(4)
    FERN_GROUPS(5) FERN_GROUPS(6) FERN_GROUPS(7) FERN_GROUPS(8)
  }
#undef FERN_GROUPS
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_attention_fp32(const void* q, const void* k, const void* v,
                                  const float* bias, void* out, int batch, int sq, int sk,
                                  int heads, int q_ld, int kv_ld, int causal, float scale,
                                  int gb, int sms, cudaStream_t stream) {
  if (bias == nullptr)
    return launch_tf32_groups<D, false>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld,
                                        causal, scale, gb, sms, stream);
  return launch_tf32_groups<D, true>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld,
                                     causal, scale, gb, sms, stream);
}

}  // namespace fern
