// Hopper building blocks of the wgmma kernels (sm_90a): mbarriers, TMA
// tensor and bulk copies, named barriers, wgmma descriptors and
// synchronisation, the 32-byte-swizzled column-block tile layout and the
// 128-byte-swizzled line layout, the cp.async producer for layouts TMA
// cannot address, and the host-side tensor maps. The query-block kernels
// (K1, K2) and the key-block kernels (K3, K6) in flash_attention.cu and the
// GEGLU forward (K4) and dx GEMMs (K5) in geglu.cu share them.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is found at run time)

#include <cstdint>

#include "common.cuh"

namespace fd {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one box of a 4-D tensor map (d, h, row, b) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int d, int h, int row,
                                         int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(d), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}
// one box of a 2-D tensor map (column, row) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap& map, int col, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}
// one box of shared memory to a 2-D tensor map (column, row); clipped at
// the map's bounds
__device__ __forceinline__ void tma_store_2d(const CUtensorMap& map, int col, int row, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
               ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(src)
               : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap& map, int d, int h, int row, int b,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(d), "r"(h), "r"(row), "r"(b), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until at most N committed bulk groups of this thread still read shared memory
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// generic-proxy shared-memory writes made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed wgmma groups of this warpgroup are in flight
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers that an in-flight wgmma reads or writes in place: the
// compiler may neither move their other uses across this point nor reuse them
template <int R>
__device__ __forceinline__ void keep(float (&r)[R]) {
  #pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&r)[R][4]) {
  #pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// wgmma shared-memory descriptor for the 32-byte swizzle (layout type 3);
// lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}
// wgmma shared-memory descriptor for a K-major tile of 128-byte lines (64
// bf16) with the 128-byte swizzle (layout type 1): 8-line atoms of 1024
// bytes apart (SBO); the leading offset is unused for this layout. The tile
// starts on a 1024-byte boundary; a 16-deep step within the line adds 32
// bytes to `addr`.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// byte offset of element (r, c), c < 64, in a tile of 128-byte lines with
// TMA's 128-byte swizzle: the 16-byte chunk c / 8 of line r sits at chunk
// (c / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c / 8) ^ (r % 8)) & 7) << 4) + (c % 8) * 2;
}
// byte offset of element (r, c) in a tile of `rows` rows kept as column
// blocks of 16 bf16 (32-byte rows) with TMA's 32-byte swizzle: address bit
// 4 (which 16-byte half) flips with bit 7 (r / 4 odd)
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c / 16) * rows * 32 + r * 32 + ((((c % 16) / 8) ^ ((r >> 2) & 1)) << 4) + (c % 8) * 2;
}

// the fallback producer: rows [row0, row0 + ROWS) of a [*, D] slab (row
// stride `stride`) into the swizzled tile at `dst` by the 32 lanes of one
// warp; zero outside the slab and past D. `pairs`: 4-byte cp.async (even D,
// 4-byte aligned), else plain loads and shared stores
template <int DP, int ROWS>
__device__ __forceinline__ void copy_tile(uint32_t dst, const __nv_bfloat16* src, long stride, int row0,
                                          int n_rows, int D, bool pairs, int lane) {
  constexpr int NP = DP / 2;  // bf16 pairs a row
  for (int idx = lane; idx < ROWS * NP; idx += 32) {
    const int r = idx / NP, c = (idx % NP) * 2;
    const bool row_ok = row0 + r < n_rows;
    const __nv_bfloat16* g = src + (long)(row0 + r) * stride + c;
    const uint32_t a = dst + swz(r, c, ROWS);
    if (pairs) {
      cp_async4(a, row_ok && c < D ? g : src, row_ok && c < D);
    } else {
      const auto* u = reinterpret_cast<const unsigned short*>(g);
      const uint32_t lo = row_ok && c < D ? u[0] : 0u, hi = row_ok && c + 1 < D ? u[1] : 0u;
      st_shared(a, lo | (hi << 16));
    }
  }
}

// ---- host: TMA tensor maps ----

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's driver entry point, so the library links no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// a bf16 [B, N, H, D] tensor as a 4-D map (d, h, row, b) with a box of 16
// head-dim values x `rows` rows and the 32-byte swizzle; out-of-bounds
// elements read as zero and are not written
inline bool tensor_map(CUtensorMap* map, const void* base, int B, int N, int H, int D, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * N * H * D};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 row-major matrix [rows, cols] (row stride `ld` elements, a multiple
// of 8) as a 2-D map with a box of 16 columns x `box_rows` rows and the
// 32-byte swizzle (the column-block tiles of K5's GEMMs), or with `lines`
// a box of 64 columns (one 128-byte line) x `box_rows` rows and the 128-byte
// swizzle (K4's tiles); out-of-bounds elements read as zero and are not
// written
inline bool tensor_map_2d(CUtensorMap* map, const void* base, long rows, long cols, long ld, int box_rows,
                          bool lines = false) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * ld};
  const cuuint32_t box[2] = {lines ? 64u : 16u, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, lines ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fd
