// The attention core's bf16 kernel at head dim 80 (attention_bf16.cuh).

#include "attention_bf16.cuh"

namespace fern {

cudaError_t launch_attention_bf16_d80(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int batch, int sq, int sk,
                                      int heads, int q_ld, int kv_ld, int causal, float scale,
                                      int out_dtype, int gb, cudaStream_t stream) {
  return launch_attention_bf16<80>(q, k, v, bias, out, batch, sq, sk, heads, q_ld, kv_ld,
                                   causal, scale, out_dtype, gb, stream);
}

}  // namespace fern
