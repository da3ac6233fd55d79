// Cross-attention at any head dim up to 1,024: kernel B8's wide route.
// The (image, head) pairs of q rows [B, Sq, *] at row stride q_ld against
// k and v rows [B, Sk, *] at row stride kv_ld, head h at columns h*D ..
// h*D+D-1 of each; out [B, Sq, H*D]. `packed_kv_cross_attention` passes
// q [B, Sq, W] and the two halves of packed kv [B, Sk, 2W].
//
// Replaces: `_packed_cross_kernel` / `_packed_cross_pallas`
// (fashionern_aaai2024_tpu/ops/attention.py:240-283) at the head dims the
// attention core (attention.cu: 64 and 80) does not take. The JAX
// dispatch sends those to `_packed_cross_ref` (ops/attention.py:286-296,
// 344-357), the same function; the port's rule is that a CUDA tensor runs
// a hand-written kernel, so this kernel takes them. The site: CaLa's two
// single-head attentions (fashionern_aaai2024_tpu/models/zoo/cala.py), at
// head dim 512 on ViT-B-16 and 640 on RN50x4, 13 patch tokens a side.
//
// Rounding follows the core and `packed_kv_cross_attention_plain`: fp32
// scores times the scale, softmax in fp32 (max first), p = exp(s - m) / l
// as the IEEE fp32 quotient rounded to the operand type, P . V summed in
// fp32 and cast to the output type. fp32 products run by 3xTF32 on the
// tensor cores (attention_tf32.cuh `mma3_tf32`: each operand split into
// tf32 hi and lo, lo.hi + hi.lo + hi.hi into a fresh partial folded into
// the fp32 sum on the CUDA cores at every k-step), so fp32 agrees with the
// plain version to within the fp32 tolerance; bf16 products run as bf16
// mma with fp32 accumulators (attention_mma.cuh), as the core's do.
//
// Bound: CaLa's call at B = 128, Sq = Sk = 13, D = 512, one head moves q,
// k, v and out once, 13.6 MB in fp32 (0.0041 ms at 3.35 TB/s), against
// 4 Sq Sk D = 0.35 MFLOP an image (44 MFLOP, three tf32 passes: 0.0003 ms
// at 495 TFLOP/s): it is bound by bytes, and by the latency of a block's
// chain (load, score, softmax, P . V, store), since there is one block an
// SM.
//
// Design: one block of 8 warps takes one (image, head, tile of 16 query
// rows), grid flattened to one dimension, so that at Sq <= 16 each
// image's K and V are read once (CaLa: 128 blocks on 132 SMs).
//   * A warp owns columns: the head dim is padded to 16-column units, and
//     warp w owns units [UPW w, UPW w + UPW) of Q, K, V and out (UPW: the
//     units / 8 rounded up, one kernel instance each, 1-8). It stages
//     them, scores over them and computes those output columns, so it
//     waits for its own copies only (`cp.async.wait_group` and a warp
//     barrier) and refills a ring stage it has read without a block
//     barrier. The block meets twice a key chunk at most: once to sum the
//     warps' partial scores, once for P (CaLa: two barriers in all).
//   * Every load is in flight before any compute: the Q tile, then K and V
//     in chunks of 16 keys, each chunk a commit group, through a ring of
//     `nb` stages. The launcher sizes the ring to what shared memory holds
//     (up to 2 x the chunks: CaLa's Q, K and V are all requested at once;
//     at D = 1,024 and Sk = 256 K alone is 1 MB, and the ring streams K,
//     then V). 16-byte `cp.async` (LDGSTS) where the pointers, the row
//     strides and the head dim allow, else 4-byte, else (bf16 at an odd
//     head dim) element copies, chosen by the launcher (attention_mma.cuh
//     `staging_width`); a warp's copies run along its row segments,
//     unrolled. Rows past Sq or Sk and columns past D are zero-filled and
//     not read. Shared rows are round16(D) + 8 elements (8 mod 16: the
//     fragment loads are conflict-free).
//   * S = Q K^T a chunk at a time on the tensor cores over each warp's
//     units: fp32 by 3xTF32 m16n8k8, bf16 by m16n8k16 on `ldmatrix`
//     fragments. The warps' partial [16, 16] tiles go to shared memory
//     (two buffers where there are several chunks), and after the barrier
//     thread (r, j) sums score (r, j) in warp order, times the scale: row r
//     is a half-warp.
//   * Softmax over the row's half-warp in the plain version's two-pass
//     order (max, then exp(s - m) and its sum, then p / l by `__fdiv_rn`),
//     rounded to the operand type: no online rescaling, so the rounding
//     points stay. Earlier chunks' scores wait in the score tile
//     [16, Sk] fp32 (at most 16 KB), the last chunk's in registers.
//   * O = P V a chunk at a time over each warp's units, P read from the
//     score tile as the A operand, V's fragments from the stage (fp32:
//     3xTF32; bf16: `ldmatrix.trans`); the sums stay in registers (8 UPW a
//     thread) and go to the output once (8-byte pair stores where the head
//     dim is even).
//   * No branch inside the product loops: where each 8-key tile or unit
//     sat behind its own guard, the compiler could not hoist the next
//     tile's shared loads, and every tile paid its load, split and mma
//     latency in turn. Past-the-end units re-read the warp's last unit and
//     are not stored.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "attention_tf32.cuh"

namespace fern {
namespace {

constexpr int kWideRows = 16;  // query rows of a block (the mma's M)
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideMaxDim = 1024;
constexpr int kWideMaxKeys = 256;
constexpr int kWideChunk = 16;                       // keys of a ring stage
constexpr int kWideMaxStages = 8;                    // ring stages (wait_pending's range)
constexpr int kWideMaxUpw = kWideMaxDim / 16 / kWideWarps;  // 16-column units a warp
constexpr int kPartLd = kWideChunk + 8;              // a partial score row, in words
static_assert(kWideThreads == kWideRows * kWideChunk, "a thread a score of a chunk");
// shared memory of a block: with the opt-in, and its share when two blocks
// share an SM (228 KB an SM, 1 KB of it reserved a block)
constexpr int kWideSmemMax = 232448;
constexpr int kWideSmemPair = (233472 - 2 * 1024) / 2;

// A row's max and sum over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Staged rows: the head dim rounded up to 16 (the bf16 mma's k and a
// 16-column P . V unit), 8 more elements a row.
__host__ __device__ constexpr int wide_dp(int dim) { return (dim + 15) / 16 * 16; }
__host__ __device__ constexpr int wide_lds(int dim) { return wide_dp(dim) + 8; }
// The score tile's row: the chunks' keys rounded up to 32 words, + 4 (4
// mod 32: the A fragment loads of P . V are conflict-free).
__host__ __device__ constexpr int wide_sld(int sk) {
  return ((sk + kWideChunk - 1) / kWideChunk * kWideChunk + 31) / 32 * 32 + 4;
}

// Partial score buffers: two where the keys take more than one chunk (a
// warp may write chunk c + 1's while another thread reduces chunk c's).
__host__ __device__ constexpr int wide_parts(int sk) { return sk > kWideChunk ? 2 : 1; }

template <typename T>
__host__ __device__ constexpr size_t wide_smem_bytes(int dim, int sk, int nb) {
  return sizeof(float) * ((size_t)wide_parts(sk) * kWideWarps * kWideRows * kPartLd +
                          (size_t)kWideRows * wide_sld(sk)) +
         sizeof(T) * (size_t)(kWideRows + nb * kWideChunk) * wide_lds(dim);
}

// Waits until at most n of this thread's commit groups are pending (n
// below kWideMaxStages; the immediate of cp.async.wait_group is fixed).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// This warp's columns, units [UPW w, UPW w + UPW) below `units` (16
// columns each; [c0, c_end)), of a shared tile of 16 rows at row stride
// wide_lds(cols): rows [0, rows) and columns [0, cols) from `src` at row
// stride `ld`, zeros elsewhere; the lanes run along the rows, so a copy
// instruction covers whole row segments, and the copies are unrolled (a
// rolled loop issued a tiny tile's copies one slow step at a time).
// `kWidth`: the launcher's staging width (16 needs
// cols a multiple of 16 bytes, 4 a multiple of 4 bytes; 2: bf16 element
// copies, synchronous).
template <typename T, int UPW, int kWidth>
__device__ __forceinline__ void wide_stage_by(T* dst, const T* __restrict__ src, int ld,
                                              int rows, int cols, int c0, int c_end,
                                              int lane) {
  constexpr int kCols = UPW * 16;                              // a warp's columns
  constexpr int kPer = kWidth == 2 ? 1 : kWidth / sizeof(T);  // elements of a copy
  const int lds = wide_lds(cols);
  const unsigned base = smem_u32(dst);
#pragma unroll 4
  for (int e = lane * kPer; e < kWideRows * kCols; e += 32 * kPer) {
    const int r = e / kCols, c = c0 + e % kCols;
    if (c < c_end) {
      const bool in = r < rows && c < cols;
      const T* from = src + (size_t)r * ld + c;
      if constexpr (kWidth == 2) {
        dst[r * lds + c] = in ? *from : from_f<T>(0.f);
      } else {
        const unsigned a = base + (unsigned)((r * lds + c) * sizeof(T));
        const void* g = in ? static_cast<const void*>(from) : static_cast<const void*>(src);
        if constexpr (kWidth == 16)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(g),
                       "r"(in ? 16 : 0)
                       : "memory");
        else
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(g),
                       "r"(in ? 4 : 0)
                       : "memory");
      }
    }
  }
}

template <typename T, int UPW>
__device__ __forceinline__ void wide_stage(T* dst, const T* __restrict__ src, int ld, int rows,
                                           int cols, int units, int width, int warp,
                                           int lane) {
  const int c0 = warp * UPW * 16, c_end = min(c0 + UPW * 16, units * 16);
  if (c0 >= c_end) return;
  if (width == 16)
    wide_stage_by<T, UPW, 16>(dst, src, ld, rows, cols, c0, c_end, lane);
  else if (width == 4)
    wide_stage_by<T, UPW, 4>(dst, src, ld, rows, cols, c0, c_end, lane);
  else
    wide_stage_by<T, UPW, 2>(dst, src, ld, rows, cols, c0, c_end, lane);
}

// s[n] += the unscaled scores over the 16-column units [u0, u1) of the 16
// staged query rows against 8-key tile n of a staged 16-key chunk (keys
// past the operand are zero rows), in the accumulator layout (s[n][0],
// [1]: row g, keys 8n + 2t, + 1; [2], [3]: row g + 8).
template <int UPW>
__device__ __forceinline__ void wide_scores(float (&s)[2][4], const float* qs, const float* ks,
                                            int lds, int u0, int u1, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int uu = 0; uu < UPW; ++uu) {
    const int un = u0 + uu;
    if (un >= u1) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // k-steps of 8 dims: 16 un, 16 un + 8
      const int d = un * 16 + half * 8 + 2 * t;
      uint32_t ah[4], al[4];  // A: dims d (k index t), d + 1 (t + 4)
      const float2 r0 = *reinterpret_cast<const float2*>(qs + g * lds + d);
      const float2 r1 = *reinterpret_cast<const float2*>(qs + (g + 8) * lds + d);
      split_tf32(r0.x, ah[0], al[0]);
      split_tf32(r1.x, ah[1], al[1]);
      split_tf32(r0.y, ah[2], al[2]);
      split_tf32(r1.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(ks + (n * 8 + g) * lds + d);
        uint32_t bh[2], bl[2];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        mma3_tf32(s[n], ah, al, bh, bl);
      }
    }
  }
}

template <int UPW>
__device__ __forceinline__ void wide_scores(float (&s)[2][4], const bf16* qs, const bf16* ks,
                                            int lds, int u0, int u1, int lane) {
  const bf16* qp = qs + (lane % 16) * lds + (lane / 16) * 8;
  const bf16* kp = ks + ((lane % 8) + 8 * (lane / 16)) * lds + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int uu = 0; uu < UPW; ++uu) {  // a unit is one k-step
    const int un = u0 + uu;
    if (un >= u1) break;
    unsigned a[4], b[4];
    ldmatrix_x4(a, qp + un * 16);
    ldmatrix_x4(b, kp + un * 16);  // b[0], b[1]: keys 0-7; b[2], b[3]: keys 8-15
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
}

// o[u] += P . V over a staged 16-key chunk for the 16-column units u0 + u,
// u < UPW (o[u][n]: columns 16 (u0 + u) + 8n + 2t, + 1 of rows g ([0],
// [1]) and g + 8); pp: the chunk's probabilities in the score tile (row
// stride sld), zero past the keys, whose V rows are zero. A unit at or
// past u1 reads unit u1 - 1 again and is not stored.
template <int UPW>
__device__ __forceinline__ void wide_pv(float (&o)[UPW][2][4], const float* pp, int sld,
                                        const float* vs, int lds, int u0, int u1, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    uint32_t ah[4], al[4];  // A: row g, key t (a0) and t + 4 (a2); a1, a3 row g + 8
    const float* p = pp + kt * 8 + t;
    split_tf32(p[g * sld], ah[0], al[0]);
    split_tf32(p[(g + 8) * sld], ah[1], al[1]);
    split_tf32(p[g * sld + 4], ah[2], al[2]);
    split_tf32(p[(g + 8) * sld + 4], ah[3], al[3]);
    const float* v0 = vs + (kt * 8 + t) * lds + g;  // B: key t, column g; key t + 4
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int c = min(u0 + u, u1 - 1) * 16;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[c + n * 8], bh[0], bl[0]);
        split_tf32(v0[4 * lds + c + n * 8], bh[1], bl[1]);
        mma3_tf32(o[u][n], ah, al, bh, bl);
      }
    }
  }
}

template <int UPW>
__device__ __forceinline__ void wide_pv(float (&o)[UPW][2][4], const float* pp, int sld,
                                        const bf16* vs, int lds, int u0, int u1, int lane) {
  const int g = lane / 4, t = lane % 4;
  unsigned pa[4];  // A: row g, keys 2t, 2t + 1 (pa[0]) and 2t + 8, + 9 (pa[2]); row g + 8
  const float* p0 = pp + g * sld + 2 * t;
  const float* p1 = p0 + 8 * sld;
  pa[0] = pack_bf16(p0[0], p0[1]);
  pa[1] = pack_bf16(p1[0], p1[1]);
  pa[2] = pack_bf16(p0[8], p0[9]);
  pa[3] = pack_bf16(p1[8], p1[9]);
  const bf16* vp = vs + (lane % 16) * lds + (lane / 16) * 8;
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    unsigned b[4];  // b[0], b[1]: columns 0-7; b[2], b[3]: 8-15
    ldmatrix_x4_trans(b, vp + min(u0 + u, u1 - 1) * 16);
    mma_bf16(o[u][0], pa, b[0], b[1]);
    mma_bf16(o[u][1], pa, b[2], b[3]);
  }
}

// The block's (image, head, 16-row tile): the file's design notes. UPW:
// the 16-column units a warp owns; nb: ring stages (1 .. kWideMaxStages);
// width: the staging width.
template <typename T, int UPW>
__device__ __forceinline__ void wide_attention(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, T* __restrict__ out,
                                               int sq, int sk, int heads, int dim, int q_ld,
                                               int kv_ld, int tiles, float scale, int nb,
                                               int width) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int lds = wide_lds(dim), sld = wide_sld(sk);
  const int units = wide_dp(dim) / 16;                // 16-column units
  const int nc = (sk + kWideChunk - 1) / kWideChunk;  // key chunks
  float* part = reinterpret_cast<float*>(wide_smem);  // wide_parts x [warps][16][kPartLd]
  float* ps = part + wide_parts(sk) * kWideWarps * kWideRows * kPartLd;  // [16][sld]
  T* qs = reinterpret_cast<T*>(ps + kWideRows * sld);  // [16][lds]
  T* ring = qs + kWideRows * lds;                      // nb x [16][lds]

  // (no division where a pair has one tile or an image one head)
  const int pair = tiles == 1 ? blockIdx.x : blockIdx.x / tiles;  // image * heads + head
  const int tile = blockIdx.x - pair * tiles;
  const int b = heads == 1 ? pair : pair / heads, h = pair - b * heads;
  const int row0 = tile * kWideRows;
  const int rows = min(kWideRows, sq - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = warp * UPW, u1 = min(u0 + UPW, units);  // this warp's units
  const bool holds = u0 < u1;
  const size_t col = static_cast<size_t>(h) * dim;
  const T* qb = q + (static_cast<size_t>(b) * sq + row0) * q_ld + col;
  const T* kb = k + static_cast<size_t>(b) * sk * kv_ld + col;
  const T* vb = v + static_cast<size_t>(b) * sk * kv_ld + col;

  // Chunk ch: K's keys 16ch .. for ch < nc, then V's, into stage ch % nb,
  // each warp its own units, one commit group a chunk (empty for a warp
  // that holds no unit). A warp reads only its own units of the stages, so
  // it waits for its own copies and refills a stage it has read at once.
  const int nch = 2 * nc;
  auto issue = [&](int ch) {
    const int c = ch < nc ? ch : ch - nc;
    const T* src = (ch < nc ? kb : vb) + static_cast<size_t>(c) * kWideChunk * kv_ld;
    wide_stage<T, UPW>(ring + (ch % nb) * kWideChunk * lds, src, kv_ld,
                       min(kWideChunk, sk - c * kWideChunk), dim, units, width, warp, lane);
    cp_async_commit();
  };
  wide_stage<T, UPW>(qs, qb, q_ld, rows, dim, units, width, warp, lane);
  cp_async_commit();
  int issued = 0;
  for (; issued < min(nb, nch); ++issued) issue(issued);

  float o[UPW][2][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n) o[u][n][0] = o[u][n][1] = o[u][n][2] = o[u][n][3] = 0.f;
  const int g = lane / 4, t = lane % 4;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_pending(issued - ch - 1);  // this thread's copies of chunk ch (and Q)
    __syncwarp();
    const T* st = ring + (ch % nb) * kWideChunk * lds;
    const int c = ch < nc ? ch : ch - nc;
    if (ch >= nc) {
      if (holds) wide_pv<UPW>(o, ps + c * kWideChunk, sld, st, lds, u0, u1, lane);
      __syncwarp();
      if (issued < nch) issue(issued++);
      continue;
    }
    // the partial scores over this warp's units, in buffer c % 2: a
    // thread reduces chunk c - 1 from the other one while a faster warp
    // writes these
    float* pc = part + (c % 2) * kWideWarps * kWideRows * kPartLd;
    if (holds) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      wide_scores<UPW>(s, qs, st, lds, u0, u1, lane);
      float* pw = pc + warp * kWideRows * kPartLd;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        *reinterpret_cast<float2*>(pw + g * kPartLd + n * 8 + 2 * t) =
            make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(pw + (g + 8) * kPartLd + n * 8 + 2 * t) =
            make_float2(s[n][2], s[n][3]);
      }
    }
    __syncwarp();
    if (issued < nch) issue(issued++);
    __syncthreads();  // every warp's partials of chunk c
    // score (r, 16c + j): the partials summed in warp order, times the
    // scale; row r is the 16 threads 16r .. 16r + 15 (half a warp), which
    // hold its keys j, j + 16, ... in the score tile
    const int r = threadIdx.x / kWideChunk, j = threadIdx.x % kWideChunk;
    float* pr = ps + r * sld + j;
    const bool key = c * kWideChunk + j < sk;
    float x = -INFINITY;
    if (key) {
      x = pc[r * kPartLd + j];
      for (int w = 1; w < min(kWideWarps, (units + UPW - 1) / UPW); ++w)
        x = __fadd_rn(x, pc[(w * kWideRows + r) * kPartLd + j]);
      x = __fmul_rn(x, scale);
    }
    if (ch < nc - 1) {
      if (key) pr[c * kWideChunk] = x;
      continue;
    }
    // softmax of row r over its half-warp: max, exp(s - m) and its sum,
    // p / l (the IEEE quotient) rounded to T; zero past the keys. The last
    // chunk's scores stay in registers (CaLa's 13 keys: one chunk).
    float m = x;
    for (int cc = 0; cc < c; ++cc) m = fmaxf(m, pr[cc * kWideChunk]);
    m = half_warp_max(m);
    float l = 0.0f;
    for (int cc = 0; cc < c; ++cc) {
      const float e = expf(pr[cc * kWideChunk] - m);
      pr[cc * kWideChunk] = e;
      l += e;
    }
    const float e = key ? expf(x - m) : 0.0f;
    l = half_warp_sum(l + e);
    for (int cc = 0; cc < c; ++cc)
      pr[cc * kWideChunk] = round_to<T>(__fdiv_rn(pr[cc * kWideChunk], l));
    pr[c * kWideChunk] = key ? round_to<T>(__fdiv_rn(e, l)) : 0.0f;
    __syncthreads();  // P
  }

  // the tile's rows of out, columns 16 unit + 8n + 2t, + 1
  const size_t o_ld = static_cast<size_t>(heads) * dim;
  T* ob = out + (static_cast<size_t>(b) * sq + row0) * o_ld + col;
  const bool pairs = dim % 2 == 0;
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = u0 + u;
    if (unit < u1) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c0 = unit * 16 + n * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g + 8 * half;
          if (r < rows && c0 < dim) {
            T* p = ob + r * o_ld + c0;
            const float x = o[u][n][2 * half], y = o[u][n][2 * half + 1];
            if (pairs) {
              store_pair(p, x, y);
            } else {
              p[0] = from_f<T>(x);
              if (c0 + 1 < dim) p[1] = from_f<T>(y);
            }
          }
        }
      }
    }
  }
}

// The fp32 instances (3xTF32 mma) and the bf16 instances (bf16 mma), one
// a count of units a warp.
template <int UPW>
__global__ void __launch_bounds__(kWideThreads, UPW <= 4 ? 2 : 1)
wide_tf32_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int sq, int sk,
                           int heads, int dim, int q_ld, int kv_ld, int tiles, float scale,
                           int nb, int width) {
  wide_attention<float, UPW>(q, k, v, out, sq, sk, heads, dim, q_ld, kv_ld, tiles, scale, nb,
                             width);
}

template <int UPW>
__global__ void __launch_bounds__(kWideThreads, UPW <= 4 ? 2 : 1)
wide_mma_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int sk,
                          int heads, int dim, int q_ld, int kv_ld, int tiles, float scale,
                          int nb, int width) {
  wide_attention<bf16, UPW>(q, k, v, out, sq, sk, heads, dim, q_ld, kv_ld, tiles, scale, nb,
                            width);
}

// The launch of one instance: the ring's stages, the most (up to both
// operands' chunks) that fit the block's shared memory (its share of two
// blocks an SM when the grid outnumbers the SMs, so that one block's loads
// overlap the other's compute), and the staging width.
template <typename T, auto Kernel>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out, int batch,
                        int sq, int sk, int heads, int dim, int q_ld, int kv_ld, float scale,
                        int device, cudaStream_t stream) {
  const int tiles = (sq + kWideRows - 1) / kWideRows;
  const long long blocks = static_cast<long long>(tiles) * heads * batch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t budget = blocks > sm_count(device) ? kWideSmemPair : kWideSmemMax;
  const int nc = (sk + kWideChunk - 1) / kWideChunk;
  int nb = min(2 * nc, kWideMaxStages);
  while (nb > 1 && wide_smem_bytes<T>(dim, sk, nb) > budget) --nb;
  const size_t smem = wide_smem_bytes<T>(dim, sk, nb);
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int width = staging_width({q, k, v}, {q_ld, kv_ld, dim}, (int)sizeof(T));
  Kernel<<<static_cast<unsigned>(blocks), kWideThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, heads, dim, q_ld, kv_ld, tiles, scale, nb, width);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fern

// q, k, v: the first head's first row of each operand (k and v may point
// into one packed tensor); q_ld / kv_ld: row strides in elements; dtype:
// the operands' and the output's type. Head dims 1 .. 1,024, 1 .. 256 keys.
extern "C" int fern_attention_wide(const void* q, const void* k, const void* v, void* out,
                                   int batch, int sq, int sk, int heads, int head_dim,
                                   int q_ld, int kv_ld, float scale, int dtype, int device,
                                   void* stream) {
  using namespace fern;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (sk < 1 || sk > kWideMaxKeys || head_dim < 1 || head_dim > kWideMaxDim || heads < 1 ||
      batch < 0 || sq < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the 16-column units a warp holds
  const int upw = ((head_dim + 15) / 16 + kWideWarps - 1) / kWideWarps;
  static_assert(kWideMaxUpw == 8, "one instance per count of units a warp");
#define FERN_WIDE(UPW)                                                                        \
  case UPW:                                                                                   \
    return (int)(dtype == DTYPE_F32                                                           \
                     ? launch_wide<float, wide_tf32_attention_kernel<UPW>>(                   \
                           q, k, v, out, batch, sq, sk, heads, head_dim, q_ld, kv_ld, scale,  \
                           device, s)                                                         \
                     : launch_wide<bf16, wide_mma_attention_kernel<UPW>>(                     \
                           q, k, v, out, batch, sq, sk, heads, head_dim, q_ld, kv_ld, scale,  \
                           device, s));
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  switch (upw) {
    FERN_WIDE(1) FERN_WIDE(2) FERN_WIDE(3) FERN_WIDE(4)
    FERN_WIDE(5) FERN_WIDE(6) FERN_WIDE(7) FERN_WIDE(8)
  }
#undef FERN_WIDE
  return (int)cudaErrorInvalidValue;
}
