// The TMA ring's pieces, shared by gemm.cu (the bf16 GEMM of kernels B1,
// B2, B7 and B12 in bf16), gemm_tf32.cu (the fp32 GEMM: B1, B2, B7 and
// B12 in fp32) and bbc_loss.cu (kernel B4): mbarriers in shared memory,
// one 2-D tile copy by the Tensor Memory Accelerator completing a
// barrier's transaction bytes, and the tensor maps those copies read,
// encoded on the host.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace fern {

// A wait longer than this many SM clock cycles (~10 s) means a copy or a
// release never came: the kernel traps (a launch error) instead of hanging.
constexpr long long kWaitTimeout = 1LL << 34;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitTimeout) __trap();
  }
}
// One box of a 2-D tensor map (coordinates: k, row) into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver, found once through the
// runtime (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// What a tensor map is a function of: the map is a pure function of these
// (the matrix's address, type and extents, and the box), so a cached map
// is valid for as long as its key is the same.
struct MapKey {
  const void* ptr;
  int type, elem_bytes, rows, k, box_k, box_rows;
  bool operator==(const MapKey& o) const { return std::memcmp(this, &o, sizeof(MapKey)) == 0; }
};

struct MapKeyHash {
  size_t operator()(const MapKey& key) const {
    size_t h = reinterpret_cast<size_t>(key.ptr);
    for (int v : {key.type, key.elem_bytes, key.rows, key.k, key.box_k, key.box_rows})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

// The tensor map of a row-major [rows, k] matrix of `elem_bytes`-byte
// elements (row stride k elements) read in boxes of box_rows x box_k, in
// the 128-byte swizzle (box_k * elem_bytes == 128), zero past its edges.
// Encoding is a driver call on the host for every operand of every
// launch, so maps are kept by key (the weights' recur every call; the
// activations' recur as the caching allocator hands their addresses out
// again); the table is emptied when it reaches kMapCacheSize entries.
constexpr size_t kMapCacheSize = 4096;

inline cudaError_t tile_map(CUtensorMap* map, CUtensorMapDataType type, size_t elem_bytes,
                            const void* ptr, int rows, int k, int box_k, int box_rows) {
  MapKey key;
  std::memset(&key, 0, sizeof(key));  // no padding bytes of garbage in the compare
  key.ptr = ptr;
  key.type = static_cast<int>(type);
  key.elem_bytes = static_cast<int>(elem_bytes);
  key.rows = rows;
  key.k = k;
  key.box_k = box_k;
  key.box_rows = box_rows;
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *map = it->second;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (cache.size() >= kMapCacheSize) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

}  // namespace fern
