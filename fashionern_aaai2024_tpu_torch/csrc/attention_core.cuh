// The body of the port's softmax attention core: one (image, head) pair,
// query rows [row0, row1), run by one block of kAttnWarps warps.
//
// Shared by attention.cu (kernels B3, B7-B9 and the cores of B1 and B6:
// one block per (head, image), all rows) and block.cu (kernel B10, whose
// persistent blocks walk (image, head, row tile) units). Each .cu file
// compiles in its own nvcc process, so the body lives here as an inline
// device function. The design notes are in attention.cu.
#pragma once

#include <math.h>

#include "common.cuh"

namespace fern {

constexpr int kMaxSeq = 256;
constexpr int kAttnWarps = 8;

// K row stride in elements: an odd number of 32-bit words
template <typename T, int D> struct KStride;
template <int D> struct KStride<bf16, D> { static constexpr int value = D + 2; };
template <int D> struct KStride<float, D> { static constexpr int value = D + 1; };

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T, int D>
__host__ __device__ constexpr size_t attention_smem_bytes(int sk) {
  return align16((size_t)sk * KStride<T, D>::value * sizeof(T)) +
         align16((size_t)sk * D * sizeof(T)) +
         (size_t)kAttnWarps * (D + kMaxSeq) * sizeof(float);
}

// Rows [row0, row1) of head h of image b. smem: attention_smem_bytes(Sk)
// bytes, 16-byte aligned. With `causal` (Sq == Sk) only the keys up to
// row1 are staged: later keys carry the -1e30 bias for every row here.
// Ends with a block barrier, so the caller may restage at once.
// kBias: the bias is a template flag, so the kernels without one (B1,
// B3, B6, B7, B8, B10) compile to the same code as before it existed.
template <typename T, typename TO, int D, bool kBias>
__device__ __forceinline__ void attention_rows(unsigned char* smem, const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               const float* __restrict__ bias,
                                               TO* __restrict__ out, int b, int h, int row0,
                                               int row1, int Sq, int Sk, int H, int q_ld,
                                               int kv_ld, int causal, float scale) {
  static_assert(D % 2 == 0 && D <= 128, "head dim: even, at most 128");
  constexpr int kPairs = D / 2;
  constexpr int kPairRounds = (kPairs + 31) / 32;
  constexpr int kld = KStride<T, D>::value;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16((size_t)Sk * kld * sizeof(T)));
  float* qbuf = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Vs) +
                                         align16((size_t)Sk * D * sizeof(T)));
  float* pbuf = qbuf + kAttnWarps * D;

  const int W = H * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)b * Sq * q_ld + h * D;
  const T* kb = k + (size_t)b * Sk * kv_ld + h * D;
  const T* vb = v + (size_t)b * Sk * kv_ld + h * D;

  const int staged = causal ? min(row1, Sk) : Sk;
  for (int idx = threadIdx.x; idx < staged * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    Ks[j * kld + d] = kb[(size_t)j * kv_ld + d];
    Vs[j * D + d] = vb[(size_t)j * kv_ld + d];
  }
  __syncthreads();

  float* qw = qbuf + warp * D;
  float* pw = pbuf + warp * kMaxSeq;
  for (int i = row0 + warp; i < row1; i += kAttnWarps) {
    const T* qrow = qb + (size_t)i * q_ld;
    for (int d = lane; d < D; d += 32) qw[d] = to_f(qrow[d]);
    __syncwarp();
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qw[d];

    const int jmax = causal ? i + 1 : Sk;  // keys past i carry the -1e30 bias: p = 0
    const float* brow = kBias ? bias + (size_t)i * Sk : nullptr;
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
        for (int d = 0; d < D; d += 2) {
          const float2 kv = load2(kr + d);
          dot = fmaf(qr[d], kv.x, dot);
          dot = fmaf(qr[d + 1], kv.y, dot);
        }
        // the bias is added to the rounded product, as the plain version
        // does (no fused multiply-add)
        if constexpr (kBias)
          s[t] = __fadd_rn(__fmul_rn(dot, scale), brow[j]);
        else
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

    TO* orow = out + ((size_t)b * Sq + i) * W + h * D;
#pragma unroll
    for (int r = 0; r < kPairRounds; ++r) {
      const int d = 2 * (lane + 32 * r);
      if (d < D) {
        float o0 = 0.f, o1 = 0.f;
        for (int j = 0; j < jmax; ++j) {
          const float p = pw[j];
          const float2 vv = load2(Vs + j * D + d);
          o0 = fmaf(p, vv.x, o0);
          o1 = fmaf(p, vv.y, o1);
        }
        orow[d] = from_f<TO>(o0);
        orow[d + 1] = from_f<TO>(o1);
      }
    }
    __syncwarp();  // qw / pw are rewritten by the next row
  }
  __syncthreads();  // Ks / Vs are read before anyone restages them
}

}  // namespace fern
