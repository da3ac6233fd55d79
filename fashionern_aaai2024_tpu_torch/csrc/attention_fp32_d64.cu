// The attention core's fp32 kernel at head dim 64 (attention_fp32.cuh).

#include "attention_fp32.cuh"

namespace fern {

cudaError_t launch_attention_fp32_d64(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int batch, int sq, int sk,
                                      int heads, int q_ld, int kv_ld, int causal, float scale,
                                      int gb, int sms, cudaStream_t stream) {
  return launch_attention_fp32<64>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld,
                                   causal, scale, gb, sms, stream);
}

}  // namespace fern
