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
// projections and the hidden layer are GEMM launches (the projections
// written straight into the two halves of the [M, 8d] concat buffer; fp32
// on the tensor cores by 3xTF32, `gemm_tf32.cu`, bf16 on `gemm.cu`), and
// this kernel finishes each row (ops/combiner.py). The hidden product
// applies its own bias and ReLU, or, split over K where its tiles alone
// would leave SMs idle (fp32 at small M), leaves fp32 partial products
// that this kernel sums, adds the bias to and ReLUs as it reads them.
//
// Bound: bytes. It reads the hidden row (8d), the text and image rows and
// the gate weights once, and writes d values a row; a few operations an
// element. Design: one block per row, every array read four elements at
// a time (16-byte loads in fp32), the two row reductions (the gate's dot
// product, the sum of squares) as warp shuffles and one exchange of warp
// sums through shared memory. The blend is recomputed in the second
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

// Four consecutive elements of T as fp32, and back (16 bytes in fp32, 8 in
// bf16; the caller keeps the addresses aligned to that).
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<bf16>(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

// Hidden elements c..c+3 of a row: the finished h (bf16 path), or the sum
// of the split-K partial products (in slice order) plus bias, ReLU, cast
// (fp32 path).
template <typename T>
__device__ __forceinline__ float4 hidden4(const T* h, const float* hp, int splits, const T* bh,
                                          size_t row, int m, int hd, int c) {
  if (hp == nullptr) return load4(h + row * hd + c);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(hp + ((size_t)z * m + row) * hd + c);
    v = make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
  }
  const float4 b = load4(bh + c);
  return make_float4(round_to<T>(fmaxf(v.x + b.x, 0.f)), round_to<T>(fmaxf(v.y + b.y, 0.f)),
                     round_to<T>(fmaxf(v.z + b.z, 0.f)), round_to<T>(fmaxf(v.w + b.w, 0.f)));
}

// sigma * text + (1 - sigma) * image, element by element, in fp32.
__device__ __forceinline__ float4 blend4(float sigma, float rest, float4 t, float4 i) {
  return make_float4(__fadd_rn(__fmul_rn(sigma, t.x), __fmul_rn(rest, i.x)),
                     __fadd_rn(__fmul_rn(sigma, t.y), __fmul_rn(rest, i.y)),
                     __fadd_rn(__fmul_rn(sigma, t.z), __fmul_rn(rest, i.z)),
                     __fadd_rn(__fmul_rn(sigma, t.w), __fmul_rn(rest, i.w)));
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
  for (int c = 4 * threadIdx.x; c < hd; c += 4 * kGateThreads) {
    const float4 v = hidden4(h, hp, splits, bh, row, m, hd, c), w = load4(wo + c);
    acc = fmaf(v.x, w.x, acc);
    acc = fmaf(v.y, w.y, acc);
    acc = fmaf(v.z, w.z, acc);
    acc = fmaf(v.w, w.w, acc);
  }
  const float logit = block_sum(acc, red) + to_f(bo[0]);
  const float sigma = 1.0f / (1.0f + expf(-logit));
  const float rest = 1.0f - sigma;
  const T* tr = text + row * d;
  const T* ir = image + row * d;
  float ss = 0.f;
  for (int c = 4 * threadIdx.x; c < d; c += 4 * kGateThreads) {
    const float4 o = blend4(sigma, rest, load4(tr + c), load4(ir + c));
    ss = fmaf(o.x, o.x, ss);
    ss = fmaf(o.y, o.y, ss);
    ss = fmaf(o.z, o.z, ss);
    ss = fmaf(o.w, o.w, ss);
  }
  const float norm = fmaxf(sqrtf(block_sum(ss, red)), 1e-12f);
  T* orow = out + row * d;
  for (int c = 4 * threadIdx.x; c < d; c += 4 * kGateThreads) {
    const float4 o = blend4(sigma, rest, load4(tr + c), load4(ir + c));
    store4(orow + c, make_float4(o.x / norm, o.y / norm, o.z / norm, o.w / norm));
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
// hp of type `dtype`; d and hd multiples of 4, and every array but bo
// aligned to 4 elements (16 bytes in fp32, 8 in bf16; hp to 16 bytes).
extern "C" int fern_combiner_gate(const void* h, const void* hp, int splits, const void* bh,
                                  const void* wo, const void* bo, const void* text,
                                  const void* image, void* out, int m, int d, int hd, int dtype,
                                  int device, void* stream) {
  cudaError_t err = fern::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if ((h == nullptr) == (hp == nullptr) || (hp != nullptr && splits < 1))
    return (int)cudaErrorInvalidValue;
  const unsigned long long align = dtype == fern::DTYPE_F32 ? 16 : 8;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(h) | reinterpret_cast<unsigned long long>(bh) |
      reinterpret_cast<unsigned long long>(wo) | reinterpret_cast<unsigned long long>(text) |
      reinterpret_cast<unsigned long long>(image) | reinterpret_cast<unsigned long long>(out);
  if (d % 4 || hd % 4 || addr % align || reinterpret_cast<unsigned long long>(hp) % 16)
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
