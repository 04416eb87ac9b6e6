// Hopper (sm_90a) pieces shared by the tensor-core conv kernels
// (conv3x3_flat.cu, conv3x3_wgmma.cu) and the instance norm
// (instance_norm.cu): the wgmma wrappers and shared-memory matrix
// descriptors, the mbarrier and TMA (cp.async.bulk.tensor) load and store
// wrappers, the tensor-map encoder looked up through the CUDA runtime, and
// the per-device opt-ins for shared memory past 48 KB and for clusters of
// more than 8 blocks.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)

#include "conv3x3_common.cuh"

namespace hopper {

using conv3x3::smem_addr;

// ------------------------------------------------------------------ wgmma
// The 64 f32 accumulators of an m64n128 wgmma, as asm operands %0-%63.
#define HOPPER_D64_REGS                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                      \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                      \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                      \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                      \
  "%56, %57, %58, %59, %60, %61, %62, %63},"
#define HOPPER_D64_OPERANDS(d)                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),               \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),             \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),             \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),             \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),             \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),             \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),             \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),             \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),             \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The register-A wgmma: d[64 x N] += a[64 x 16] (bf16, from registers, the
// m16n8k16 A fragment of each warp's 16 rows) * b[16 x N] (bf16, shared
// memory, by descriptor, N-major), f32 accumulators in the m16n8 C layout of
// each warp's rows, n8 tile by n8 tile.
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      HOPPER_D64_REGS
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 8) wgmma_m64n8k16_rs(d, a, b);
  if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, b);
  if constexpr (N == 128) wgmma_m64n128k16_rs(d, a, b);
}

// The shared-memory wgmma: d[64 x 128] += a[64 x 16] (bf16, K-major, by
// descriptor) * b[16 x 128] (bf16, N-major, by descriptor), f32
// accumulators in the same layout as the register-A form.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      HOPPER_D64_REGS
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : HOPPER_D64_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, and the layout (none, or TMA's 128-byte swizzle,
// whose pattern repeats every 1024 bytes from a 1024-byte aligned base).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              bool swizzle128) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle128 ? 1ull << 62 : 0ull);
}

// Descriptor of one tap's [16 x N] B tile of conv3x3_flat, N-major. BN >= 64,
// 128-byte swizzle: 8-row groups of k 1024 bytes apart (stride byte offset),
// 64-wide atoms of n 2048 bytes apart (leading byte offset). BN = 8, no
// swizzle: the two 8-row core matrices of k 128 bytes apart (leading byte
// offset).
template <int N>
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  if constexpr (N < 64) return smem_desc(p, 128, 128, false);
  return smem_desc(p, 2048, 1024, true);
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// -------------------------------------------------------- mbarrier and TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// A TMA store of a 3-D or 4-D box from shared memory, in the bulk group of the
// issuing thread; bulk_wait_read<0>() returns once the shared memory of
// every committed store may be written again, bulk_wait<0>() once the
// stores are done.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel and per
// device: cudaFuncSetAttribute applies to the current device's copy of the
// kernel. Each caller keeps one Granted per kernel instantiation: the largest
// size granted so far on each device, and whether clusters of more than 8
// blocks were allowed there.
constexpr int MAX_DEVICES = 64;
struct Granted {
  size_t bytes[MAX_DEVICES] = {};
  bool large_clusters[MAX_DEVICES] = {};
};

template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes, Granted* granted) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= granted->bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted->bytes[dev] = bytes;
  return err;
}

// Clusters of 9 to 16 blocks (non-portable sizes) need their own opt-in, per
// kernel and per device.
template <typename Kernel>
__host__ cudaError_t allow_large_clusters(Kernel kernel, Granted* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (granted->large_clusters[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) granted->large_clusters[dev] = true;
  return err;
}

}  // namespace hopper
