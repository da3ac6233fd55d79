// Grouped softmax attention at head dim <= 128 and any key length: the
// (batch, head) pairs of q [*, Sq, D] against k, v [*, Sk, D], with an
// optional shared fp32 [Sq, Sk] bias.
//
// Replaces: `_kernel` / `mha_grouped` (benchmarks/attn_experiment.py:30-76,
// X1: G (b, h) pairs a program over padded q [BH, 208, 128] and k, v
// [BH, 256, 128]), and `_attn_kernel` / `_mha_pallas`
// (fashionern_aaai2024_tpu/ops/attention.py:61-110, B9) at the shapes the
// one-pass core in attention.cu does not take: head dims other than 64 and
// 80, and more than 256 keys (`multi_head_attention` routes them here).
//
// Layouts, as attention.cu reads them: pair p = b * H + h of `batch`
// images with H heads; q rows [batch, Sq, *] at row stride q_ld, k and v
// rows [batch, Sk, *] at row stride kv_ld, head h at columns h*D ..
// h*D+D-1; out [batch, Sq, H*D]. Contiguous [BH, S, D] is H = 1, ld = D.
//
// Bound: X1 at bf16 moves 365 MB (q, k, v and out once: 0.109 ms at 3.35
// TB/s) and computes 3 x 2 x Sq x Sk x D FLOPs a pair (QK^T twice, P.V
// once; the bound counts the 2 x 2 x Sq x Sk x D the function needs).
// This first version runs on the CUDA cores: the limit is the rate of
// fp32 FMAs fed from shared memory, not DRAM.
//
// Design: one block of 8 warps per `group` consecutive pairs, looping
// over its pairs and, within a pair, over tiles of 32 query rows (4 rows
// a warp, held as fp32 in shared memory and read as broadcasts); with
// `split_rows` each block takes one row tile of its pairs instead (grid
// y), so that a call with few pairs (B9 at long Sk) still fills the card. Keys are
// cut into chunks of 64 staged in shared memory (K at an odd word stride,
// as attention.cu, so the 32 lanes reading 32 key rows hit 32 banks), so
// shared memory does not grow with Sk: 57.6 KB a block in bf16, 90.4 KB
// in fp32, at D <= 128 (zero-padded to 64 or 128). Two passes over the
// chunks keep `_kernel`'s rounding point: the first finds each row's max
// and denominator (each lane an online max / rescaled sum over its keys,
// then a warp reduction), the second recomputes the scores and forms
// p = exp(s - m) / l rounded to the operand type, accumulating P.V in
// fp32 over the keys in order. A one-pass online softmax would divide at
// the end and round elsewhere in bf16. Each lane scores 2 keys of a chunk
// against the warp's 4 rows and owns 2 (D <= 64) or 4 output dims. No
// finite value is special-cased: a row whose every key carries the -1e30
// bias has m = -1e30 and averages its keys uniformly, as the Pallas
// kernel; keys masked with -inf add nothing to the sum, as in the one-pass
// core.

#include "attention_core.cuh"

namespace fern {
namespace {

constexpr int kGroupedWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kGroupedWarps * kRowsPerWarp;
constexpr int kChunk = 64;
constexpr int kKeysPerLane = kChunk / 32;

template <typename T, int DP>
__host__ __device__ constexpr size_t grouped_smem_bytes() {
  return align16((size_t)kChunk * KStride<T, DP>::value * sizeof(T)) +
         align16((size_t)kChunk * DP * sizeof(T)) +
         (size_t)kTileRows * DP * sizeof(float) +
         (size_t)kGroupedWarps * kRowsPerWarp * kChunk * sizeof(float);
}

// A pair of values at an 8-byte aligned address (V rows: stride DP).
__device__ __forceinline__ float2 load_pair(const bf16* p) { return load2(p); }
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Keys j0 .. j0+63 of one pair into Ks (and Vs), zero past Sk and past D.
template <typename T, int DP, bool kWithV>
__device__ __forceinline__ void stage_chunk(T* Ks, T* Vs, const T* __restrict__ kb,
                                            const T* __restrict__ vb, int j0, int Sk, int D,
                                            int kv_ld) {
  constexpr int kld = KStride<T, DP>::value;
  for (int idx = threadIdx.x; idx < kChunk * DP; idx += blockDim.x) {
    const int jj = idx / DP, d = idx % DP;
    const int j = j0 + jj;
    const bool in = j < Sk && d < D;
    Ks[jj * kld + d] = in ? kb[(size_t)j * kv_ld + d] : from_f<T>(0.f);
    if constexpr (kWithV) Vs[jj * DP + d] = in ? vb[(size_t)j * kv_ld + d] : from_f<T>(0.f);
  }
}

// Scores of this lane's two keys of the chunk (lane, lane + 32) against
// the warp's rows: s[t][r] = q_r . k, unscaled.
template <typename T, int DP>
__device__ __forceinline__ void chunk_dots(const T* Ks, const float* qw, int lane,
                                           float (&s)[kKeysPerLane][kRowsPerWarp]) {
  constexpr int kld = KStride<T, DP>::value;
  const T* k0 = Ks + lane * kld;
  const T* k1 = Ks + (lane + 32) * kld;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[t][r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; d += 2) {
    const float2 a = load2(k0 + d), b = load2(k1 + d);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float2 qv = *reinterpret_cast<const float2*>(qw + r * DP + d);
      s[0][r] = fmaf(qv.x, a.x, s[0][r]);
      s[0][r] = fmaf(qv.y, a.y, s[0][r]);
      s[1][r] = fmaf(qv.x, b.x, s[1][r]);
      s[1][r] = fmaf(qv.y, b.y, s[1][r]);
    }
  }
}

// The scaled score plus the bias, rounded in that order as the plain
// version (no fused multiply-add).
template <bool kBias>
__device__ __forceinline__ float biased(float dot, float scale, const float* __restrict__ bias,
                                        int i, int j, int Sq, int Sk) {
  if constexpr (kBias) {
    const float bv = i < Sq ? bias[(size_t)i * Sk + j] : 0.f;
    return __fadd_rn(__fmul_rn(dot, scale), bv);
  } else {
    return dot * scale;
  }
}

template <typename T, int DP, bool kBias>
__global__ void __launch_bounds__(kGroupedWarps * 32)
grouped_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, int Sq, int Sk, int H, int D, int q_ld,
                         int kv_ld, int group, float scale) {
  // blockIdx.y: the first row tile of this block, gridDim.y the stride
  static_assert(DP == 64 || DP == 128, "padded head dim: 64 or 128");
  constexpr int kld = KStride<T, DP>::value;
  constexpr int kPairRounds = DP / 64;  // output dim pairs a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16((size_t)kChunk * kld * sizeof(T)));
  float* Qs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Vs) +
                                       align16((size_t)kChunk * DP * sizeof(T)));
  float* Ps = Qs + kTileRows * DP;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qw = Qs + warp * kRowsPerWarp * DP;
  float* pw = Ps + warp * kRowsPerWarp * kChunk;
  const int W = H * D;
  const int nchunks = (Sk + kChunk - 1) / kChunk;

  for (int pi = 0; pi < group; ++pi) {
    const int p = blockIdx.x * group + pi;
    const int b = p / H, h = p % H;
    const T* qb = q + (size_t)b * Sq * q_ld + (size_t)h * D;
    const T* kb = k + (size_t)b * Sk * kv_ld + (size_t)h * D;
    const T* vb = v + (size_t)b * Sk * kv_ld + (size_t)h * D;
    T* ob = out + (size_t)b * Sq * W + (size_t)h * D;

    for (int row0 = blockIdx.y * kTileRows; row0 < Sq; row0 += gridDim.y * kTileRows) {
      __syncthreads();  // the previous tile is done with Qs, Ks, Vs
      for (int idx = threadIdx.x; idx < kTileRows * DP; idx += blockDim.x) {
        const int i = row0 + idx / DP, d = idx % DP;
        Qs[idx] = i < Sq && d < D ? to_f(qb[(size_t)i * q_ld + d]) : 0.f;
      }
      const int i0 = row0 + warp * kRowsPerWarp;  // the warp's first row

      // pass 1: each lane's running max and rescaled sum over its keys
      float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
      }
      for (int c = 0; c < nchunks; ++c) {
        const int j0 = c * kChunk;
        __syncthreads();
        stage_chunk<T, DP, false>(Ks, Vs, kb, vb, j0, Sk, D, kv_ld);
        __syncthreads();
        float s[kKeysPerLane][kRowsPerWarp];
        chunk_dots<T, DP>(Ks, qw, lane, s);
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int j = j0 + lane + 32 * t;
          if (j < Sk) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float sv = biased<kBias>(s[t][r], scale, bias, i0 + r, j, Sq, Sk);
              const float mn = fmaxf(m[r], sv);
              // a -inf score adds nothing, and while the max is still -inf
              // there is no sum to rescale (-inf - -inf would be NaN)
              l[r] = (m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mn)) +
                     (sv == -INFINITY ? 0.f : expf(sv - mn));
              m[r] = mn;
            }
          }
        }
      }
      float M[kRowsPerWarp], L[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        M[r] = warp_max(m[r]);
        L[r] = warp_sum(m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - M[r]));
      }

      // pass 2: p = exp(s - m) / l in the operand type, then P.V in fp32
      float acc[kRowsPerWarp][kPairRounds][2];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int u = 0; u < kPairRounds; ++u) acc[r][u][0] = acc[r][u][1] = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        const int j0 = c * kChunk;
        __syncthreads();
        stage_chunk<T, DP, true>(Ks, Vs, kb, vb, j0, Sk, D, kv_ld);
        __syncthreads();
        float s[kKeysPerLane][kRowsPerWarp];
        chunk_dots<T, DP>(Ks, qw, lane, s);
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int jj = lane + 32 * t, j = j0 + jj;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            float pv = 0.f;
            if (j < Sk)
              pv = round_to<T>(
                  expf(biased<kBias>(s[t][r], scale, bias, i0 + r, j, Sq, Sk) - M[r]) / L[r]);
            pw[r * kChunk + jj] = pv;
          }
        }
        __syncwarp();
        const int nk = min(kChunk, Sk - j0);
        for (int jj = 0; jj < nk; ++jj) {
          float2 vv[kPairRounds];
#pragma unroll
          for (int u = 0; u < kPairRounds; ++u)
            vv[u] = load_pair(Vs + jj * DP + 2 * (lane + 32 * u));
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float pv = pw[r * kChunk + jj];
#pragma unroll
            for (int u = 0; u < kPairRounds; ++u) {
              acc[r][u][0] = fmaf(pv, vv[u].x, acc[r][u][0]);
              acc[r][u][1] = fmaf(pv, vv[u].y, acc[r][u][1]);
            }
          }
        }
        __syncwarp();  // pw is rewritten by the next chunk
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = i0 + r;
        if (i >= Sq) continue;
#pragma unroll
        for (int u = 0; u < kPairRounds; ++u) {
          const int d = 2 * (lane + 32 * u);
          if (d < D) {
            ob[(size_t)i * W + d] = from_f<T>(acc[r][u][0]);
            ob[(size_t)i * W + d + 1] = from_f<T>(acc[r][u][1]);
          }
        }
      }
    }
  }
}

template <typename T, int DP, bool kBias>
cudaError_t launch_grouped(const void* q, const void* k, const void* v, const float* bias,
                           void* out, dim3 grid, int sq, int sk, int heads, int head_dim,
                           int q_ld, int kv_ld, int group, float scale, cudaStream_t stream) {
  constexpr size_t smem = grouped_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(grouped_attention_kernel<T, DP, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grouped_attention_kernel<T, DP, kBias><<<grid, kGroupedWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), sq, sk, heads, head_dim, q_ld, kv_ld, group, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dispatch_bias(const void* q, const void* k, const void* v, const float* bias,
                          void* out, dim3 grid, int sq, int sk, int heads, int head_dim,
                          int q_ld, int kv_ld, int group, float scale, cudaStream_t s) {
  if (bias == nullptr)
    return launch_grouped<T, DP, false>(q, k, v, bias, out, grid, sq, sk, heads, head_dim,
                                        q_ld, kv_ld, group, scale, s);
  return launch_grouped<T, DP, true>(q, k, v, bias, out, grid, sq, sk, heads, head_dim, q_ld,
                                     kv_ld, group, scale, s);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const float* bias,
                         void* out, dim3 grid, int sq, int sk, int heads, int head_dim,
                         int q_ld, int kv_ld, int group, float scale, cudaStream_t s) {
  if (head_dim <= 64)
    return dispatch_bias<T, 64>(q, k, v, bias, out, grid, sq, sk, heads, head_dim, q_ld,
                                kv_ld, group, scale, s);
  return dispatch_bias<T, 128>(q, k, v, bias, out, grid, sq, sk, heads, head_dim, q_ld,
                               kv_ld, group, scale, s);
}

}  // namespace
}  // namespace fern

// q, k, v: the first head's first row of each operand; bias: null or a
// contiguous fp32 [sq, sk] added to every pair's scores; head_dim even,
// 2 .. 128; group: pairs a block, dividing batch * heads; split_rows: 0,
// a block runs every query row of its pairs; 1, one 32-row tile of them;
// out [batch, sq, heads * head_dim] in the operands' type (fp32 or bf16).
extern "C" int fern_attention_grouped(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int batch, int sq, int sk,
                                      int heads, int head_dim, int q_ld, int kv_ld, int group,
                                      int split_rows, float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)batch * heads;
  if (sk < 1 || head_dim < 2 || head_dim > 128 || head_dim % 2 || group < 1 ||
      pairs % group || pairs / group > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (pairs == 0 || sq == 0) return 0;
  const int tiles = (sq + fern::kTileRows - 1) / fern::kTileRows;
  if (split_rows && tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(pairs / group), split_rows ? tiles : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == fern::DTYPE_BF16)
    return (int)fern::dispatch_dim<fern::bf16>(q, k, v, b, out, grid, sq, sk, heads, head_dim,
                                               q_ld, kv_ld, group, scale, s);
  if (dtype == fern::DTYPE_F32)
    return (int)fern::dispatch_dim<float>(q, k, v, b, out, grid, sq, sk, heads, head_dim, q_ld,
                                          kv_ld, group, scale, s);
  return (int)cudaErrorInvalidValue;
}
