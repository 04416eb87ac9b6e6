// Pieces shared by the 3x3 conv kernels (conv3x3.cu, conv3x3_flat.cu,
// conv3x3_im2col.cu, conv3x3_wgmma.cu): the bf16 tensor-core fragments, the
// f32 register tile's column map, the epilogue stores, the in-order sum of
// the per-tile instance-norm partials, and the shared-memory opt-in.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace conv3x3 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column j of a thread of the f32 register tile (16 threads across a block
// of BN = 16 * TN columns). TN >= 4: four adjacent columns per 64-wide group,
// read as one float4 from shared memory; TN < 4: TN adjacent columns.
template <int TN>
__device__ __forceinline__ int f32_col(int tx, int j) {
  return TN >= 4 ? (j >> 2) * 64 + tx * 4 + (j & 3) : tx * TN + j;
}

__device__ __forceinline__ float bias_relu(float acc, float b, int relu) {
  const float v = acc + b;
  return relu ? fmaxf(v, 0.f) : v;
}

// Two adjacent output channels n, n + 1 of one output row, rounded once to
// bf16; a pair store where the row allows it, else one value at a time.
__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* row, int n, int O, float v0,
                                                float v1) {
  if (n + 1 < O && (O & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (n < O) row[n] = __float2bfloat16_rn(v0);
    if (n + 1 < O) row[n + 1] = __float2bfloat16_rn(v1);
  }
}

// Adds the per-tile column partials of each image in tile order: sums[b, n]
// = sum over t of psum[b, t, n] (and the same for the squares), so the sums
// are the same bit for bit from run to run, with no atomics.
__global__ void tile_sums_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                                 float* __restrict__ sums, float* __restrict__ sumsqs, int B,
                                 int tiles, int O) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * O) return;
  const int b = i / O, n = i - (i / O) * O;
  float ts = 0.f, tq = 0.f;
  for (int t = 0; t < tiles; ++t) {
    ts += psum[((size_t)b * tiles + t) * O + n];
    tq += psq[((size_t)b * tiles + t) * O + n];
  }
  sums[i] = ts;
  sumsqs[i] = tq;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel and per
// device: cudaFuncSetAttribute applies to the current device's copy of the
// kernel. Each caller keeps one Granted per kernel instantiation, the largest
// size granted so far on each device.
constexpr int MAX_DEVICES = 64;
struct Granted {
  size_t bytes[MAX_DEVICES] = {};
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

}  // namespace conv3x3
