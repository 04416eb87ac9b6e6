// Fused single-head attention, `out = softmax(q k^T) v` over the keys, f32,
// with an online max and sum: SANet's style attention
// (models/sanet.py: one head, d = 512, no 1/sqrt(d) scale, non-causal, a
// query count Nq and a key count Nk of their own).
//
// Not the port of a TPU kernel: the JAX package has no attention. The plain
// form (ops/cuda/attention.py::attention_plain, `torch.softmax(q @ k^T) @
// v`) writes the [Nq, Nk] score matrix and its softmax to device memory:
// 1.07 GB each for SANet's relu4_1 block at 1024 px (Nq = Nk = 16,384).
// This kernel never writes it.
//   out[b, r, :] = sum_j exp(s[r, j] - m[r]) v[b, j, :] / sum_j exp(s[r, j] - m[r])
//   s[r, j] = sum_d q[b, r, d] k[b, j, d],  m[r] = max_j s[r, j]
// f32 in, f32 products and sums (no TF32), f32 out; q [B, Nq, D], k and v
// [B or 1, Nk, D] (a key batch of one serves every query image), row-major.
//
// What bounds it on an H100: operations. 4 Nq Nk D of them (q k^T and p v,
// 2 a multiply-add) against (2 Nq + 2 Nk) D floats moved: SANet's relu4_1
// block is 5.50e11 operations a pair, 8.21 ms at the 67 TFLOP/s of the CUDA
// cores, against 0.13 GB (0.04 ms); its relu5_1 block (Nq = Nk = 4,096) 0.51
// ms.
//
// Design: FMA on the CUDA cores, flash-attention's online softmax. A block
// (256 threads, one a SM: 218 KB of shared memory) owns BM = 64 query rows
// of one image and walks over the keys in tiles of BN = 128:
// - its 64 x 512 query tile stays in shared memory (129 KB) for the whole
//   walk, loaded once;
// - the output accumulator, 64 x 512 f32, lives in registers: 128 a thread
//   (8 rows x 16 columns), so the [64, 512] sum is never written until the
//   end; a thread's columns are 4 apart in 4 runs of 4, so that a warp's
//   16-byte reads of a value row fall on distinct banks;
// - a tile's scores s = q k^T (64 x 128) are 32 a thread (4 rows x 8 keys),
//   summed over d in chunks of 32 columns of the keys; the scores go to
//   shared memory key-major, each warp takes 8 rows of them through the
//   online softmax (the tile's row max and row sum by shuffles, the running
//   max m and sum l and the factor exp(m_old - m_new) per row in shared
//   memory), writes the weights p back in place, and every thread rescales
//   its accumulators by its rows' factors before it adds p v over the
//   tile's values in chunks of 8 keys;
// - key and value chunks (18 KB and 16 KB) come through one 3-stage
//   cp.async ring that runs on across tiles, so the next chunk's copies are
//   in flight while a chunk computes, the softmax included.
// Per key of p v a thread reads 2 + 4 float4 (its rows' weights, a
// broadcast, and its columns' values) for 128 FMAs; per 4 columns of d in q
// k^T, 4 + 8 float4 for 128 FMAs. Pitches of 516, 36 and 68 floats put a
// warp's reads of query rows, key rows and score columns on distinct banks.
// Keys past Nk are zeros with scores of -inf (weight 0); rows past Nq are
// zeros and are not written: ragged tails need no padded input.
//
// On an H100 (700 W) at relu4_1's call of 4 pairs: 57.4 ms, 57% of the bound,
// 254 registers a thread and no spill; cuBLAS's two f32 products and the
// softmax between them (the plain form, 4.3 GB of scores) take 45.9 ms. A
// softmax of one row a step across the warp took 60.4 ms, a block of 512
// threads (64 outputs a thread, 128 registers, spilling) 63.5 ms.
//
// Order: every output sums its products in one fixed order (key tiles
// ascending, keys ascending within a tile, each tile's sum rescaled by the
// running max), every score over d ascending, each row's max and sum by the
// same shuffle tree; there is no split over keys and no atomic, so a call
// repeats bit for bit and an image's output does not depend on the batch.
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises.

#include "hopper.cuh"

namespace {

using conv3x3::smem_addr;

constexpr int NT = 256;        // threads a block
constexpr int D = 512;         // the head's width
constexpr int BM = 64;         // query rows a block
constexpr int BN = 128;        // keys a tile
constexpr int DK = 32;         // columns of d in a key chunk
constexpr int VK = 8;          // keys in a value chunk
constexpr int QP = D + 4;      // query row pitch (floats)
constexpr int KP = DK + 4;     // key chunk row pitch
constexpr int PP = BM + 4;     // score pitch (key-major: p[key][row])
constexpr int STAGES = 3;
constexpr int K_CHUNKS = D / DK;   // 16
constexpr int V_CHUNKS = BN / VK;  // 16
constexpr int CHUNKS = K_CHUNKS + V_CHUNKS;
constexpr int STAGE = BN * KP > VK * D ? BN * KP : VK * D;
constexpr size_t SMEM =
    sizeof(float) * ((size_t)BM * QP + (size_t)STAGES * STAGE + (size_t)BN * PP + 3 * BM);
static_assert(SMEM <= 227 * 1024, "shared memory");
static_assert(BN * DK / 4 == 4 * NT && VK * D / 4 == 4 * NT && BM * D / 4 == 32 * NT, "copies");

struct Shape {
  int nq, nk, k_batch_stride;  // k_batch_stride: 0 (one key image) or 1
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory: Qs[BM][QP], the ring's STAGES stages (a key chunk
// Ks[BN][KP] or a value chunk Vs[VK][D]), Ps[BN][PP], then the running max,
// sum and rescale factor of each row.
//
// grid (ceil(Nq / BM), B).
__global__ void __launch_bounds__(NT, 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + BM * QP;
  float* Ps = ring + STAGES * STAGE;
  float* Ms = Ps + BN * PP;
  float* Ls = Ms + BM;
  float* As = Ls + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int img = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const float* qb = q + ((size_t)img * s.nq) * D;
  const size_t kv_off = (size_t)img * s.k_batch_stride * s.nk * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  const int tiles = (s.nk + BN - 1) / BN;
  const int total = tiles * CHUNKS;

  // The query tile, zeros past Nq.
#pragma unroll 4
  for (int i = 0; i < BM * D / 4 / NT; ++i) {
    const int f = tid + i * NT;
    const int row = f / (D / 4), c4 = f % (D / 4);
    const bool ok = q0 + row < s.nq;
    cp_async16(Qs + row * QP + c4 * 4, ok ? qb + (size_t)(q0 + row) * D + c4 * 4 : qb,
               ok ? 16 : 0);
  }
  cp_async_commit();

  // Chunk g of the walk: key chunk g % CHUNKS (< K_CHUNKS: columns of d of
  // the tile's keys) or value chunk (the tile's keys VK at a time), of tile
  // g / CHUNKS; zeros past Nk.
  auto load_chunk = [&](int g) {
    float* st = ring + (g % STAGES) * STAGE;
    const int t = g / CHUNKS, c = g - t * CHUNKS;
    const int key0 = t * BN;
    if (c < K_CHUNKS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = tid + i * NT;
        const int key = f / (DK / 4), c4 = f % (DK / 4);
        const bool ok = key0 + key < s.nk;
        cp_async16(st + key * KP + c4 * 4,
                   ok ? kb + (size_t)(key0 + key) * D + c * DK + c4 * 4 : kb, ok ? 16 : 0);
      }
    } else {
      const int j0 = key0 + (c - K_CHUNKS) * VK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = tid + i * NT;
        const int key = f / (D / 4), c4 = f % (D / 4);
        const bool ok = j0 + key < s.nk;
        cp_async16(st + key * D + c4 * 4, ok ? vb + (size_t)(j0 + key) * D + c4 * 4 : vb,
                   ok ? 16 : 0);
      }
    }
  };

  if (tid < BM) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    load_chunk(g);
    cp_async_commit();
  }

  // Scores: rows 16 wr + ly + 4 i, keys 64 wc + lx + 8 j of the tile.
  const int wr = warp >> 1, wc = warp & 1, ly = lane >> 3, lx = lane & 7;
  // Output: rows 32 (warp >> 2) + 8 ly + r, columns 128 (warp & 3) + 4 lx +
  // 32 c + e.
  const int orow = 32 * (warp >> 2) + 8 * ly;
  const int ocol = 128 * (warp & 3) + 4 * lx;

  float o[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[r][e] = 0.f;

  // Chunk g's stage, once it has landed and every thread is done with
  // chunk g - 1, whose stage the copies of chunk g + STAGES - 1 then take.
  auto next_stage = [&](int g) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (g + STAGES - 1 < total) load_chunk(g + STAGES - 1);
    cp_async_commit();
    return ring + (g % STAGES) * STAGE;
  };

  int g = 0;
  for (int t = 0; t < tiles; ++t) {
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < K_CHUNKS; ++c, ++g) {
      const float* qp = Qs + (16 * wr + ly) * QP + c * DK;
      const float* kp = next_stage(g) + (64 * wc + lx) * KP;
#pragma unroll
      for (int dd = 0; dd < DK; dd += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qp + 4 * i * QP + dd);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(kp + 8 * j * KP + dd);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float acc = sc[i][j];
            acc = fmaf(a[i].x, b.x, acc);
            acc = fmaf(a[i].y, b.y, acc);
            acc = fmaf(a[i].z, b.z, acc);
            sc[i][j] = fmaf(a[i].w, b.w, acc);
          }
        }
      }
    }

    // The tile's scores, key-major, -inf past Nk. The last p v of the tile
    // before read Ps before the barrier of this tile's first chunk.
    const int key0 = t * BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = 64 * wc + lx + 8 * j;
      const bool ok = key0 + key < s.nk;
#pragma unroll
      for (int i = 0; i < 4; ++i) Ps[key * PP + 16 * wr + ly + 4 * i] = ok ? sc[i][j] : -INFINITY;
    }
    __syncthreads();
    // The online softmax: warp w takes rows 8 w .. 8 w + 7, lane l row
    // l % 8 and, of its keys, 2 (l / 8) + 8 t + e (t < 16, e < 2): with the
    // score pitch of 68 floats the warp's 32 reads (and writes) of each step
    // fall on 32 banks. A row's max and sum over its four lanes by two
    // shuffles. The barrier of the next chunk orders these writes before p v.
    {
      static_assert(BM == 8 * (NT / 32) && BN == 128 && PP % 32 == 4, "softmax lanes");
      const int rr = lane & 7, qd = lane >> 3, row = 8 * warp + rr;
      float* pr = Ps + 2 * qd * PP + row;
      float x[BN / 4];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[2 * t + e] = pr[(8 * t + e) * PP];
          mx = fmaxf(mx, x[2 * t + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_old = Ms[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(x[2 * t + e] - m_new);
          pr[(8 * t + e) * PP] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      if (qd == 0) {
        const float alpha = expf(m_old - m_new);  // 0 at the first tile
        Ms[row] = m_new;
        Ls[row] = Ls[row] * alpha + sum;
        As[row] = alpha;
      }
    }

    for (int vc = 0; vc < V_CHUNKS; ++vc, ++g) {
      const float* vp = next_stage(g) + ocol;
      if (vc == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float alpha = As[orow + r];
#pragma unroll
          for (int e = 0; e < 16; ++e) o[r][e] *= alpha;
        }
      }
      const float* pp = Ps + vc * VK * PP + orow;
#pragma unroll
      for (int jj = 0; jj < VK; ++jj) {
        const float4 p0 = *reinterpret_cast<const float4*>(pp + jj * PP);
        const float4 p1 = *reinterpret_cast<const float4*>(pp + jj * PP + 4);
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 b = *reinterpret_cast<const float4*>(vp + jj * D + 32 * cc);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            o[r][4 * cc + 0] = fmaf(p[r], b.x, o[r][4 * cc + 0]);
            o[r][4 * cc + 1] = fmaf(p[r], b.y, o[r][4 * cc + 1]);
            o[r][4 * cc + 2] = fmaf(p[r], b.z, o[r][4 * cc + 2]);
            o[r][4 * cc + 3] = fmaf(p[r], b.w, o[r][4 * cc + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: divide by the row sums and write the rows inside Nq.
  float* ob = out + ((size_t)img * s.nq) * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + orow + r;
    if (row >= s.nq) break;
    const float inv = 1.f / Ls[orow + r];
    float* dst = ob + (size_t)row * D + ocol;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<float4*>(dst + 32 * cc) =
          make_float4(o[r][4 * cc] * inv, o[r][4 * cc + 1] * inv, o[r][4 * cc + 2] * inv,
                      o[r][4 * cc + 3] * inv);
  }
}

}  // namespace

extern "C" {

const char* stx_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, nq, d] f32, k and v [kb, nk, d] f32 (kb 1 or B), out [B, nq, d] f32,
// all contiguous and 16-byte aligned; d must be 512. Returns a cudaError_t
// (0 on success; cudaErrorInvalidValue for a shape the kernel does not take).
int stx_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int nq,
                      int nk, int d, int kb, void* stream) {
  static hopper::Granted granted;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (B < 1 || B > 65535 || nq < 1 || nk < 1 || d != D || (kb != 1 && kb != B) ||
      (ptrs & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = hopper::allow_smem(attention_f32_kernel, SMEM, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.nq = nq;
  s.nk = nk;
  s.k_batch_stride = kb == 1 && B > 1 ? 0 : 1;
  const dim3 grid((nq + BM - 1) / BM, B);
  attention_f32_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
