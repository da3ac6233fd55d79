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
// In fp32 it moves 730 MB (0.218 ms) and its 41.9 GFLOP run as three tf32
// passes: 0.254 ms at 495 / 3 TFLOP/s.
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
// Design, fp32: the same blocks, rounds and passes on the tensor cores by
// 3xTF32 `mma.sync` (attention_tf32.cuh: tf32 m16n8k8 tiles, each product
// as lo.hi + hi.lo + hi.hi of its operands' tf32 split, every k-step's and
// key tile's partial folded into the fp32 sum on the CUDA cores, the split
// made as fragments are loaded). The kernel is bound by latency, not by
// issue or shared memory: in exploratory probes (not kept), one block of 8
// warps an SM (double-buffered 64-key chunks, 202 KB, 172 registers) ran X1
// well behind two blocks an SM, and splitting each chunk once a block into
// hi and lo words, or three independent partials in place of the chained
// mmas, moved it little. So a block stages one 32-key chunk of raw fp32 at
// a time (K rows at DP + 8 words, V rows at DP + 4, so that the fragment
// loads are conflict-free), beside its warps' raw query rows: 103 KB at
// DP = 128, and at most 128 registers a thread (a chunk's scores are 16 a
// lane, the output 4 DP / 8), so that two blocks share an SM and cover
// each other's staging (X1's times: `ab_attention.py`, PERF.md §6). The
// k-steps and output columns past the head's D are skipped. The two passes
// keep their rounding points: p = exp(s - m) / l as the IEEE fp32 quotient,
// P . V accumulated in fp32.

#include "attention_core.cuh"
#include "attention_tf32.cuh"

namespace fern {
namespace {

constexpr int kGroupedMmaWarps = 8;
constexpr int kMmaTileRows = kGroupedMmaWarps * kMmaRows;
constexpr int kChunk = 64;

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

// fp32: keys of a chunk.
constexpr int kTfChunk = 32;

// fp32: shared bytes of grouped_attention_tf32_kernel: one chunk buffer of
// K (rows of tf32_qk_lds(DP) words) and V (tf32_v_lds(DP)), and 16 query
// rows a warp (tf32_qk_lds(DP)): 103 KB at DP = 128, so that two blocks
// share an SM.
template <int DP>
__host__ __device__ constexpr size_t grouped_tf32_smem_bytes() {
  return ((size_t)kTfChunk * (tf32_qk_lds(DP) + tf32_v_lds(DP)) +
          (size_t)kGroupedMmaWarps * kMmaRows * tf32_qk_lds(DP)) *
         sizeof(float);
}

// fp32: as the bf16 kernel, a block of kGroupedMmaWarps warps runs `group`
// pairs, within a pair rounds of 128 query rows, 16 a warp; two blocks an
// SM (at most 128 registers a thread).
template <int DP, bool kBias>
__global__ void __launch_bounds__(kGroupedMmaWarps * 32, 2)
grouped_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              float* __restrict__ out, int Sq, int Sk, int H, int D, int q_ld,
                              int kv_ld, int group, float scale, int width) {
  // blockIdx.y: the first row round of this block, gridDim.y the stride
  static_assert(DP == 64 || DP == 128, "padded head dim: 64 or 128");
  constexpr int qld = tf32_qk_lds(DP), vld = tf32_v_lds(DP);
  constexpr int kTiles = kTfChunk / kTfKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Ks = reinterpret_cast<float*>(smem);
  float* const Vs = Ks + kTfChunk * qld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* const Qw = Vs + kTfChunk * vld + warp * kMmaRows * qld;
  const int W = H * D;
  const int nchunks = (Sk + kTfChunk - 1) / kTfChunk;
  const int ksteps = (D + 7) / 8;  // k-steps the head's dims need (zeros past D)

  for (int pi = 0; pi < group; ++pi) {
    const int p = blockIdx.x * group + pi;
    const int b = p / H, h = p % H;
    const float* qb = q + (size_t)b * Sq * q_ld + (size_t)h * D;
    const float* kb = k + (size_t)b * Sk * kv_ld + (size_t)h * D;
    const float* vb = v + (size_t)b * Sk * kv_ld + (size_t)h * D;
    float* ob = out + (size_t)b * Sq * W + (size_t)h * D;
    // chunk c of K (and V), zero past Sk and past D; it has landed, and
    // every thread sees it, when this returns
    auto stage = [&](int c, bool with_v) {
      const int j0 = c * kTfChunk, n = min(kTfChunk, Sk - j0);
      stage_rows_f32<DP, tf32_qk_lds(DP)>(Ks, kb + (size_t)j0 * kv_ld, kv_ld, n, kTfChunk, D,
                                          width, threadIdx.x, blockDim.x);
      if (with_v)
        stage_rows_f32<DP, tf32_v_lds(DP)>(Vs, vb + (size_t)j0 * kv_ld, kv_ld, n, kTfChunk, D,
                                           width, threadIdx.x, blockDim.x);
      cp_async_wait_all();
      __syncthreads();
    };
    // unscaled scores of the warp's rows against the staged chunk (keys
    // past Sk are zero rows of it: scored, then masked by the caller)
    auto chunk_scores = [&](float (&s)[kTiles][4]) {
#pragma unroll
      for (int kt = 0; kt < kTiles; ++kt) s[kt][0] = s[kt][1] = s[kt][2] = s[kt][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t ah[4], al[4];
        load_q_tf32<tf32_qk_lds(DP)>(ah, al, Qw, kk, lane);
#pragma unroll
        for (int kt = 0; kt < kTiles; ++kt)
          qk_step_tf32<tf32_qk_lds(DP)>(s[kt], ah, al, Ks + kt * kTfKeyTile * qld, kk, lane);
      }
    };

    for (int row0 = blockIdx.y * kMmaTileRows; row0 < Sq; row0 += gridDim.y * kMmaTileRows) {
      __syncthreads();  // the previous round is done with every buffer
      const int r0 = row0 + warp * kMmaRows;
      const bool active = r0 < Sq;
      if (active)
        stage_rows_f32<DP, qld>(Qw, qb + (size_t)r0 * q_ld, q_ld, min(kMmaRows, Sq - r0),
                                kMmaRows, D, width, lane, 32);
      const int i0 = r0 + g, i1 = r0 + g + 8;  // this lane's rows
      const float* brow0 = kBias && i0 < Sq ? bias + (size_t)i0 * Sk : nullptr;
      const float* brow1 = kBias && i1 < Sq ? bias + (size_t)i1 * Sk : nullptr;

      // pass 1: each row's running max (over its quad) and this lane's
      // share of the rescaled sum
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        stage(c, false);  // with the query rows, the first time
        if (active) {
          float s[kTiles][4];
          chunk_scores(s);
          float c0 = -INFINITY, c1 = -INFINITY;
          const bool full = (c + 1) * kTfChunk <= Sk;
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = c * kTfChunk + kt * kTfKeyTile + 2 * t + e % 2;
              const bool hi = e / 2;
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
            for (int e = 0; e < 4; ++e) {
              const bool hi = e / 2;
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
        __syncthreads();  // the chunk is restaged by the next iteration
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const double rl0 = 1.0 / l0, rl1 = 1.0 / l1;

      // pass 2: p = exp(s - m) / l in fp32, then P.V in 3xTF32
      float o[DP / 8][4];
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        stage(c, true);
        if (active) {
          float s[kTiles][4];
          chunk_scores(s);
          const bool full = (c + 1) * kTfChunk <= Sk;
#pragma unroll
          for (int kt = 0; kt < kTiles; ++kt) {
            float pr[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = c * kTfChunk + kt * kTfKeyTile + 2 * t + e % 2;
              const bool hi = e / 2;
              pr[e] = full || j < Sk
                          ? div_rn(expf(scaled_score<kBias>(s[kt][e], scale, hi ? brow1 : brow0,
                                                            j) -
                                        (hi ? m1 : m0)),
                                   hi ? rl1 : rl0)
                          : 0.f;
            }
            pv_tile_tf32<vld, DP / 8>(o, pr, Vs + kt * kTfKeyTile * vld, lane, D);
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
    constexpr size_t smem = grouped_tf32_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(grouped_attention_tf32_kernel<DP, kBias>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int width = staging_width({q, k, v}, {q_ld, kv_ld, head_dim}, 4);
    grouped_attention_tf32_kernel<DP, kBias><<<grid, kGroupedMmaWarps * 32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), sq, sk, heads, head_dim,
        q_ld, kv_ld, group, scale, width);
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
// rows);
// out [batch, sq, heads * head_dim] in the operands' type (fp32 or bf16).
extern "C" int fern_attention_grouped(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int batch, int sq, int sk,
                                      int heads, int head_dim, int q_ld, int kv_ld, int group,
                                      int split_rows, float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)batch * heads;
  if (sk < 1 || head_dim < 2 || head_dim > 128 || head_dim % 2 || group < 1 ||
      pairs % group || pairs / group > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (pairs == 0 || sq == 0) return 0;
  const int tiles = (sq + fern::kMmaTileRows - 1) / fern::kMmaTileRows;
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
