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
// fp32 and cast to the output type. Products run on the CUDA cores in
// fp32 (fmaf), so fp32 agrees with the plain version to summation order.
//
// Bound: CaLa's call at B = 128, Sq = Sk = 13, D = 512, one head moves q,
// k, v and out once, 13.6 MB in fp32 (0.0041 ms at 3.35 TB/s), and needs
// 4 Sq Sk D = 0.35 MFLOP an image (44 MFLOP: 0.0007 ms at 67 TFLOP/s): it
// is bound by bytes, and the design reads each operand once a row tile.
//
// Design (simple first; no tensor cores): one block of 8 warps takes one
// (image, head, tile of kWideRows query rows), grid flattened to one
// dimension. The tile's query rows are staged in shared memory as fp32
// [kWideRows, D] (zero past Sq); the scores live in shared memory as an
// fp32 tile [kWideRows, Sk]. Q . K: a warp takes a key, its lanes split
// the head dim (coalesced loads of the key row), each lane keeps
// kWideRows partial sums and a shuffle reduction closes each. Softmax: a
// warp a row. P . V: threads over output columns, a column's kWideRows
// sums in registers over every key, so the loads of V and the stores of
// out coalesce. At D <= 1,024 and Sk <= 256 shared memory stays under 40
// KB, inside the 48 KB a block takes without an opt-in.

#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace fern {
namespace {

constexpr int kWideRows = 8;
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideMaxDim = 1024;
constexpr int kWideMaxKeys = 256;

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
wide_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int sq, int sk, int heads,
                      int dim, int q_ld, int kv_ld, int tiles, float scale) {
  extern __shared__ float wide_smem[];
  float* qs = wide_smem;                    // [kWideRows, dim]
  float* ps = wide_smem + kWideRows * dim;  // [kWideRows, sk]
  const int tile = blockIdx.x % tiles;
  const int pair = blockIdx.x / tiles;      // image * heads + head
  const int h = pair % heads, b = pair / heads;
  const int row0 = tile * kWideRows;
  const int rows = min(kWideRows, sq - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t col = static_cast<size_t>(h) * dim;
  const T* qb = q + (static_cast<size_t>(b) * sq + row0) * q_ld + col;
  const T* kb = k + static_cast<size_t>(b) * sk * kv_ld + col;
  const T* vb = v + static_cast<size_t>(b) * sk * kv_ld + col;

  for (int i = threadIdx.x; i < kWideRows * dim; i += kWideThreads) {
    const int r = i / dim, c = i - r * dim;
    qs[i] = r < rows ? to_f(qb[static_cast<size_t>(r) * q_ld + c]) : 0.0f;
  }
  __syncthreads();

  // S = Q K^T * scale, a warp a key; rows past Sq score 0 and are not read
  for (int j = warp; j < sk; j += kWideWarps) {
    const T* kr = kb + static_cast<size_t>(j) * kv_ld;
    float acc[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) acc[r] = 0.0f;
    for (int c = lane; c < dim; c += 32) {
      const float kc = to_f(kr[c]);
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) acc[r] = fmaf(qs[r * dim + c], kc, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) ps[r * sk + j] = r < rows ? s * scale : 0.0f;
    }
  }
  __syncthreads();

  // softmax a warp a row: max, exp(s - m) and its sum, p / l rounded to T
  for (int r = warp; r < rows; r += kWideWarps) {
    float* pr = ps + r * sk;
    float m = -INFINITY;
    for (int j = lane; j < sk; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < sk; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < sk; j += 32) pr[j] = round_to<T>(__fdiv_rn(pr[j], l));
  }
  __syncthreads();

  // O = P V, threads over output columns
  const size_t o_ld = static_cast<size_t>(heads) * dim;
  T* ob = out + (static_cast<size_t>(b) * sq + row0) * o_ld + col;
  for (int c = threadIdx.x; c < dim; c += kWideThreads) {
    float acc[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) acc[r] = 0.0f;
    for (int j = 0; j < sk; ++j) {
      const float vc = to_f(vb[static_cast<size_t>(j) * kv_ld + c]);
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) acc[r] = fmaf(ps[r * sk + j], vc, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r)
      if (r < rows) ob[static_cast<size_t>(r) * o_ld + c] = from_f<T>(acc[r]);
  }
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
  const int tiles = (sq + kWideRows - 1) / kWideRows;
  const long long blocks = static_cast<long long>(tiles) * heads * batch;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWideRows * (head_dim + sk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == DTYPE_F32)
    wide_attention_kernel<float><<<grid, kWideThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, heads, head_dim, q_ld,
        kv_ld, tiles, scale);
  else if (dtype == DTYPE_BF16)
    wide_attention_kernel<bf16><<<grid, kWideThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), sq, sk, heads, head_dim, q_ld, kv_ld, tiles, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
