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
//
// Two passes over 64-key chunks keep `_kernel`'s rounding point: the
// first finds each row's max and denominator (an online max / rescaled
// sum over the chunks), the second recomputes the scores and forms
// p = exp(s - m) / l rounded to the operand type, accumulating P.V in
// fp32. A one-pass online softmax would divide at the end and round
// elsewhere in bf16. No finite value is special-cased: a row whose every
// key carries the -1e30 bias has m = -1e30 and averages its keys
// uniformly, as the Pallas kernel; keys masked with -inf add nothing to
// the sum, and while a row's max is still -inf there is no sum to rescale
// (-inf - -inf would be NaN), as in the one-pass core. Shared memory does
// not grow with Sk.
//
// Design, bf16: the tensor-core tiles of attention_mma.cuh. A block of
// kGroupedMmaWarps (8) warps runs `group` consecutive pairs, and within a
// pair rounds of 128 query rows, 16 a warp (with `split_rows` each block
// takes one round of its pairs instead, grid y, so that a call with few
// pairs, B9 at long Sk, still fills the card). Eight warps share each
// staged chunk: at about 250 registers a thread one such block fills an
// SM's register file, as two blocks of four would, with half the
// restaging of K and V. The head is zero-padded
// to DP = 64 or 128 columns in shared memory. Chunks of K (pass 1) and of
// K and V (pass 2) go through a double-buffered ring of `cp.async`
// copies, so chunk c + 1 loads while chunk c is scored: 16-byte copies
// when the pointers, strides and D allow (D % 8 == 0), else 4-byte (D is
// even) or element copies (`staging_width`). Scores and P.V as in the
// core.
//
// Design, fp32 (the CUDA cores, kept bit for bit): blocks of 8 warps over
// tiles of 32 query rows (4 rows a warp, held as fp32 in shared memory
// and read as broadcasts), chunks of 64 keys staged element by element (K
// at an odd word stride, so the 32 lanes reading 32 key rows hit 32
// banks): 90.4 KB a block at D <= 128 (zero-padded to 64 or 128). Each
// lane keeps an online max and rescaled sum over its keys in pass 1, then
// a warp reduction; each lane scores 2 keys of a chunk against the warp's
// 4 rows and owns 2 (D <= 64) or 4 output dims.

#include "attention_core.cuh"

namespace fern {
namespace {

constexpr int kGroupedMmaWarps = 8;
constexpr int kMmaTileRows = kGroupedMmaWarps * kMmaRows;
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

// bf16: shared bytes of grouped_attention_mma_kernel: two chunk buffers of
// K and V, and 16 query rows a warp, rows of mma_lds(DP) elements.
template <int DP>
__host__ __device__ constexpr size_t grouped_mma_smem_bytes() {
  return (size_t)(4 * kChunk + kGroupedMmaWarps * kMmaRows) * mma_lds(DP) * sizeof(bf16);
}

template <int DP, bool kBias>
__global__ void __launch_bounds__(kGroupedMmaWarps * 32)
grouped_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ bias,
                             bf16* __restrict__ out, int Sq, int Sk, int H, int D, int q_ld,
                             int kv_ld, int group, float scale, int width) {
  // blockIdx.y: the first row round of this block, gridDim.y the stride
  static_assert(DP == 64 || DP == 128, "padded head dim: 64 or 128");
  constexpr int lds = mma_lds(DP);
  constexpr int kTiles = kChunk / kKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16* const Kbuf[2] = {base, base + 2 * kChunk * lds};
  bf16* const Vbuf[2] = {base + kChunk * lds, base + 3 * kChunk * lds};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  bf16* const Qw = base + 4 * kChunk * lds + warp * kMmaRows * lds;
  const int W = H * D;
  const int nchunks = (Sk + kChunk - 1) / kChunk;

  for (int pi = 0; pi < group; ++pi) {
    const int p = blockIdx.x * group + pi;
    const int b = p / H, h = p % H;
    const bf16* qb = q + (size_t)b * Sq * q_ld + (size_t)h * D;
    const bf16* kb = k + (size_t)b * Sk * kv_ld + (size_t)h * D;
    const bf16* vb = v + (size_t)b * Sk * kv_ld + (size_t)h * D;
    bf16* ob = out + (size_t)b * Sq * W + (size_t)h * D;
    // chunk c of K (and V) into buffer c % 2, zero past Sk and past D
    auto stage = [&](int c, bool with_v) {
      const int j0 = c * kChunk, n = min(kChunk, Sk - j0);
      stage_tile<DP>(Kbuf[c % 2], kb + (size_t)j0 * kv_ld, kv_ld, n, kChunk, D, width,
                     threadIdx.x, blockDim.x);
      if (with_v)
        stage_tile<DP>(Vbuf[c % 2], vb + (size_t)j0 * kv_ld, kv_ld, n, kChunk, D, width,
                       threadIdx.x, blockDim.x);
    };

    for (int row0 = blockIdx.y * kMmaTileRows; row0 < Sq; row0 += gridDim.y * kMmaTileRows) {
      __syncthreads();  // the previous round is done with every buffer
      const int r0 = row0 + warp * kMmaRows;
      const bool active = r0 < Sq;
      if (active)
        stage_tile<DP>(Qw, qb + (size_t)r0 * q_ld, q_ld, min(kMmaRows, Sq - r0), kMmaRows, D,
                       width, lane, 32);
      const int i0 = r0 + g, i1 = r0 + g + 8;  // this lane's rows
      const float* brow0 = kBias && i0 < Sq ? bias + (size_t)i0 * Sk : nullptr;
      const float* brow1 = kBias && i1 < Sq ? bias + (size_t)i1 * Sk : nullptr;
      unsigned qf[DP / 16][4];

      // pass 1: each row's running max (over its quad) and this lane's
      // share of the rescaled sum
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      stage(0, false);
      cp_async_commit();
      for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) stage(c + 1, false);
        cp_async_commit();
        cp_async_wait_one();  // chunk c (and the query rows) have landed
        __syncthreads();
        if (active) {
          if (c == 0) load_q_frags<DP>(qf, Qw, lane);
          float s[kTiles][8];
          float c0 = -INFINITY, c1 = -INFINITY;
          // keys past Sk are zero rows of the chunk: scored, then masked
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt)
            qk_tile<DP>(s[kt], qf, Kbuf[c % 2] + kt * kKeyTile * lds, lane);
          const bool full = (c + 1) * kChunk <= Sk;
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = c * kChunk + kt * kKeyTile + (e / 4) * 8 + 2 * t + e % 2;
              const bool hi = (e / 2) % 2;
              const float x =
                  full || j < Sk ? scaled_score<kBias>(s[kt][e], scale, hi ? brow1 : brow0, j)
                                 : -INFINITY;
              s[kt][e] = x;
              if (hi)
                c1 = fmaxf(c1, x);
              else
                c0 = fmaxf(c0, x);
            }
          }
          const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
          // a -inf score adds nothing, and while the max is still -inf
          // there is no sum to rescale (-inf - -inf would be NaN)
          l0 = m0 == -INFINITY ? 0.f : l0 * expf(m0 - n0);
          l1 = m1 == -INFINITY ? 0.f : l1 * expf(m1 - n1);
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const bool hi = (e / 2) % 2;
              const float x = s[kt][e];
              if (hi)
                l1 += x == -INFINITY ? 0.f : expf(x - n1);
              else
                l0 += x == -INFINITY ? 0.f : expf(x - n0);
            }
          }
          m0 = n0;
          m1 = n1;
        }
        __syncthreads();  // buffer c % 2 is restaged by the next iteration
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const double rl0 = 1.0 / l0, rl1 = 1.0 / l1;

      // pass 2: p = exp(s - m) / l in bf16, then P.V in fp32
      float o[DP / 8][4];
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
      stage(0, true);
      cp_async_commit();
      for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) stage(c + 1, true);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        if (active) {
          float s[kTiles][8];
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt)
            qk_tile<DP>(s[kt], qf, Kbuf[c % 2] + kt * kKeyTile * lds, lane);
          const bool full = (c + 1) * kChunk <= Sk;
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = c * kChunk + kt * kKeyTile + (e / 4) * 8 + 2 * t + e % 2;
              const bool hi = (e / 2) % 2;
              s[kt][e] = full || j < Sk
                             ? expf(scaled_score<kBias>(s[kt][e], scale, hi ? brow1 : brow0, j) -
                                    (hi ? m1 : m0))
                             : 0.f;
            }
            unsigned pa[4];
            probs_bf16(pa, s[kt], rl0, rl1);
            pv_tile<DP>(o, pa, Vbuf[c % 2] + kt * kKeyTile * lds, lane);
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd) {
          const int d = nd * 8 + 2 * t;
          if (d < D) {
            if (i0 < Sq) store_pair(ob + (size_t)i0 * W + d, o[nd][0], o[nd][1]);
            if (i1 < Sq) store_pair(ob + (size_t)i1 * W + d, o[nd][2], o[nd][3]);
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
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = grouped_mma_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(grouped_attention_mma_kernel<DP, kBias>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int width = staging_width({q, k, v}, {q_ld, kv_ld, head_dim});
    grouped_attention_mma_kernel<DP, kBias><<<grid, kGroupedMmaWarps * 32, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        bias, static_cast<bf16*>(out), sq, sk, heads, head_dim, q_ld, kv_ld, group, scale,
        width);
    return cudaGetLastError();
  } else {
    constexpr size_t smem = grouped_smem_bytes<T, DP>();
    cudaError_t err = cudaFuncSetAttribute(grouped_attention_kernel<T, DP, kBias>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    grouped_attention_kernel<T, DP, kBias><<<grid, kGroupedWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<T*>(out), sq, sk, heads, head_dim, q_ld, kv_ld, group, scale);
    return cudaGetLastError();
  }
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
// a block runs every query row of its pairs; 1, one row tile of them (128
// rows in bf16, 32 in fp32);
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
  const int tile_rows = dtype == fern::DTYPE_BF16 ? fern::kMmaTileRows : fern::kTileRows;
  const int tiles = (sq + tile_rows - 1) / tile_rows;
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
