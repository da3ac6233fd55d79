// Self-attention straight from packed qkv: kernel B3, and the attention
// core of kernel B1.
//
// Replaces: `_packed_kernel` / `_packed_pallas`
// (fashionern_aaai2024_tpu/ops/attention.py:124-163) and the per-head
// loop inside `_subblock_kernel` (ops/attention.py:496-510).
//
// qkv [B, S, 3W] (q | k | v, each W = H x 64 wide) -> out [B, S, W], in
// the qkv type or in fp32: kernel B6 (`_qattn_kernel`, ops/qmlp.py:186-201)
// keeps the concatenated heads in fp32 before it quantizes them.
// Heads are sliced in the kernel, so the [B, H, S, 64] layout is never
// built in device memory.
//
// Bound: at S <= 256 the scores of one head fit on chip, so DRAM traffic
// is only qkv in and out once; the limit is shared-memory bandwidth
// feeding fp32 FMAs (2 x S^2 x 64 a head). This first version runs on
// the CUDA cores, not the tensor cores.
// Design: one block per (head, image), K and V of the head staged in
// shared memory (the K rows padded to an odd word stride so that the 32
// lanes reading 32 different rows hit 32 banks). One warp per query
// row: each lane scores up to 8 keys with q held in registers, the
// softmax reductions are warp shuffles, and each lane then owns two of
// the 64 output dims for the P . V sum. Rounding follows the Pallas
// kernel: fp32 scores and softmax, probabilities normalized in fp32 and
// cast to the storage type, fp32 P . V, output cast per head.

#include <math.h>

#include "common.cuh"

namespace fern {

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 256;
constexpr int kAttnWarps = 8;

template <typename T> struct KStride;
template <> struct KStride<bf16> { static constexpr int value = 66; };   // 33 words
template <> struct KStride<float> { static constexpr int value = 65; };  // 65 words

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
__host__ __device__ constexpr size_t attention_smem_bytes(int seq) {
  return align16((size_t)seq * KStride<T>::value * sizeof(T)) +
         align16((size_t)seq * kHeadDim * sizeof(T)) +
         (size_t)kAttnWarps * (kHeadDim + kMaxSeq) * sizeof(float);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kAttnWarps * 32)
attention_kernel(const T* __restrict__ qkv, TO* __restrict__ out, int S, int H, int causal,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kld = KStride<T>::value;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16((size_t)S * kld * sizeof(T)));
  float* qbuf = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Vs) +
                                         align16((size_t)S * kHeadDim * sizeof(T)));
  float* pbuf = qbuf + kAttnWarps * kHeadDim;

  const int h = blockIdx.x, b = blockIdx.y;
  const int W = H * kHeadDim, W3 = 3 * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3;

  for (int idx = threadIdx.x; idx < S * kHeadDim; idx += blockDim.x) {
    const int j = idx / kHeadDim, d = idx % kHeadDim;
    Ks[j * kld + d] = base[(size_t)j * W3 + W + h * kHeadDim + d];
    Vs[j * kHeadDim + d] = base[(size_t)j * W3 + 2 * W + h * kHeadDim + d];
  }
  __syncthreads();

  float* qw = qbuf + warp * kHeadDim;
  float* pw = pbuf + warp * kMaxSeq;
  for (int i = warp; i < S; i += kAttnWarps) {
    const T* qrow = base + (size_t)i * W3 + h * kHeadDim;
    qw[lane] = to_f(qrow[lane]);
    qw[lane + 32] = to_f(qrow[lane + 32]);
    __syncwarp();
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = qw[d];

    const int jmax = causal ? i + 1 : S;  // keys past i carry the -1e30 bias: p = 0
    float s[kMaxSeq / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < jmax) {
        const T* kr = Ks + j * kld;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; d += 2) {
          const float2 kv = load2(kr + d);
          dot = fmaf(q[d], kv.x, dot);
          dot = fmaf(q[d + 1], kv.y, dot);
        }
        s[t] = dot * scale;
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float denom = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < jmax ? expf(s[t] - m) : 0.f;
      denom += s[t];
    }
    denom = warp_sum(denom);
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < jmax) pw[j] = round_to<T>(s[t] / denom);
    }
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < jmax; ++j) {
      const float p = pw[j];
      const float2 v = load2(Vs + j * kHeadDim + 2 * lane);
      o0 = fmaf(p, v.x, o0);
      o1 = fmaf(p, v.y, o1);
    }
    TO* orow = out + ((size_t)b * S + i) * W + h * kHeadDim;
    orow[2 * lane] = from_f<TO>(o0);
    orow[2 * lane + 1] = from_f<TO>(o1);
    __syncwarp();  // qw / pw are rewritten by the next row
  }
}

template <typename T, typename TO>
static cudaError_t launch_attention(const void* qkv, void* out, int batch, int seq, int heads,
                                    int causal, float scale, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<T>(seq);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(heads, batch);
  attention_kernel<T, TO><<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<TO*>(out), seq, heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace fern

// dtype: the qkv type; out_dtype: the output's, the same or fp32.
extern "C" int fern_attention(const void* qkv, void* out, int batch, int seq, int heads,
                              int causal, float scale, int dtype, int out_dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (seq > fern::kMaxSeq) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using fern::bf16;
  using fern::launch_attention;
  if (dtype == fern::DTYPE_BF16 && out_dtype == fern::DTYPE_BF16)
    return (int)launch_attention<bf16, bf16>(qkv, out, batch, seq, heads, causal, scale, s);
  if (dtype == fern::DTYPE_BF16 && out_dtype == fern::DTYPE_F32)
    return (int)launch_attention<bf16, float>(qkv, out, batch, seq, heads, causal, scale, s);
  if (dtype == fern::DTYPE_F32 && out_dtype == fern::DTYPE_F32)
    return (int)launch_attention<float, float>(qkv, out, batch, seq, heads, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
