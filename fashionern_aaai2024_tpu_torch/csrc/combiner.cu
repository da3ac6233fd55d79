// The gate, blend and L2 norm of kernel B12, the sigma-gated combiner in
// eval: per row, logit = h . w_out + b_out in fp32, sigma = sigmoid(logit),
// out = sigma * text + (1 - sigma) * image in fp32, then
// out / max(||out||, 1e-12), cast to the storage type.
//
// Replaces: the tail of `_combiner_kernel` / `_combiner_pallas`
// (fashionern_aaai2024_tpu/ops/combiner.py:50-59, 63-106). The TPU kernel
// ran the whole combiner in one program with every weight resident in
// VMEM; at d = 640 the hidden matrix alone is 105 MB in fp32, so the port
// splits the program where the data stops fitting: the two ReLU
// projections and the hidden layer are three `gemm.cu` products (the
// projections written straight into the two halves of the [M, 8d] concat
// buffer), and this kernel finishes each row (ops/combiner.py). In bf16
// the hidden product applies its own bias and ReLU; in fp32 it is split
// over K (`fern_gemm_f32_partials`), and this kernel sums the partial
// products, adds the bias and applies the ReLU as it reads them.
//
// Bound: bytes. It reads the hidden row (8d), the text and image rows and
// the gate weights once, and writes d values a row; a few operations an
// element. Design: one block per row, the two row reductions (the gate's
// dot product, the sum of squares) as warp shuffles and one exchange of
// warp sums through shared memory. The blend is recomputed in the second
// pass from the input rows (L1 hits) rather than kept in shared memory.
// Rounding follows the Pallas kernel: the hidden row is cast to the
// storage type before the gate reads it; the logit, sigmoid, blend and
// norm are fp32.

#include <math.h>

#include "common.cuh"

namespace fern {

constexpr int kGateThreads = 256;

// Sum over the block; every thread gets the total. `red` holds one float
// per warp and is free again when this returns.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kGateThreads / 32 ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

// One hidden element: the finished h (bf16 path), or the sum of the
// split-K partial products plus bias, ReLU, cast (fp32 path).
template <typename T>
__device__ __forceinline__ float hidden(const T* h, const float* hp, int splits, const T* bh,
                                        size_t row, int m, int hd, int c) {
  if (hp == nullptr) return to_f(h[row * hd + c]);
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += hp[((size_t)z * m + row) * hd + c];
  return round_to<T>(fmaxf(v + to_f(bh[c]), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
combiner_gate_kernel(const T* __restrict__ h, const float* __restrict__ hp, int splits,
                     const T* __restrict__ bh, const T* __restrict__ wo,
                     const T* __restrict__ bo, const T* __restrict__ text,
                     const T* __restrict__ image, T* __restrict__ out, int m, int d, int hd) {
  __shared__ float red[kGateThreads / 32];
  const size_t row = blockIdx.x;
  float acc = 0.f;
  for (int c = threadIdx.x; c < hd; c += kGateThreads)
    acc = fmaf(hidden(h, hp, splits, bh, row, m, hd, c), to_f(wo[c]), acc);
  const float logit = block_sum(acc, red) + to_f(bo[0]);
  const float sigma = 1.0f / (1.0f + expf(-logit));
  const float rest = 1.0f - sigma;
  const T* tr = text + row * d;
  const T* ir = image + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kGateThreads) {
    const float o = __fadd_rn(__fmul_rn(sigma, to_f(tr[c])), __fmul_rn(rest, to_f(ir[c])));
    ss = fmaf(o, o, ss);
  }
  const float norm = fmaxf(sqrtf(block_sum(ss, red)), 1e-12f);
  T* orow = out + row * d;
  for (int c = threadIdx.x; c < d; c += kGateThreads) {
    const float o = __fadd_rn(__fmul_rn(sigma, to_f(tr[c])), __fmul_rn(rest, to_f(ir[c])));
    orow[c] = from_f<T>(o / norm);
  }
}

template <typename T>
static cudaError_t launch_gate(const void* h, const void* hp, int splits, const void* bh,
                               const void* wo, const void* bo, const void* text,
                               const void* image, void* out, int m, int d, int hd,
                               cudaStream_t stream) {
  combiner_gate_kernel<T><<<m, kGateThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(hp), splits,
      static_cast<const T*>(bh), static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<const T*>(text), static_cast<const T*>(image), static_cast<T*>(out), m, d,
      hd);
  return cudaGetLastError();
}

}  // namespace fern

// Either h, the finished [m, hd] hidden layer (bias and ReLU applied, in
// the storage type), or hp, `splits` fp32 partial products [splits, m, hd]
// to which the hidden bias bh [hd] is added; wo: the gate's [hd] weight
// row, bo its [1] bias; text, image, out: [m, d]. All contiguous, all but
// hp of type `dtype`.
extern "C" int fern_combiner_gate(const void* h, const void* hp, int splits, const void* bh,
                                  const void* wo, const void* bo, const void* text,
                                  const void* image, void* out, int m, int d, int hd, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((h == nullptr) == (hp == nullptr) || (hp != nullptr && splits < 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fern::DTYPE_BF16)
    return (int)fern::launch_gate<fern::bf16>(h, hp, splits, bh, wo, bo, text, image, out, m,
                                              d, hd, s);
  if (dtype == fern::DTYPE_F32)
    return (int)fern::launch_gate<float>(h, hp, splits, bh, wo, bo, text, image, out, m, d,
                                         hd, s);
  return (int)cudaErrorInvalidValue;
}
