// 3x3 VALID convolution + bias (+ReLU) of a pre-padded NHWC image, no
// statistics: the im2col form, one product of depth K = 9*C.
//
// Replaces the TPU kernel styletransfer_tpu/ops/pallas/conv3x3.py
// (conv3x3_im2col -> _im2col_kernel): the same function as conv3x3_flat.cu,
// computed as [M, 9C] x [9C, O] with the im2col operand built on chip. The
// port runs the 3x3 convs with few input channels (C < 32) on it: in the
// Gatys tower that is conv1_1 (C = 3 -> 64), where nine per-tap products of
// depth 3 would leave the multiply units idle and one product of depth 27
// does not. It runs once per Gatys closure, twice per train step.
//
// What bounds it on an H100: conv1_1 at 256 px, x [B, 258, 258, 3] -> 64,
// reads 0.8 MB (f32) per image and writes 16.8 MB (f32) or 8.4 MB (bf16):
// the output write bounds it, 5.2 us (f32) and 2.6 us (bf16) per image at
// 3.35 TB/s. Its 0.23 GFLOP per image take 3.4 us on the CUDA cores at 67
// TFLOP/s (f32; TF32 is off) and 0.23 us on the tensor cores (bf16).
//
// Two routes; the wrapper (ops/cuda/conv3x3_flat.py::im2col_plan) names the
// one a shape takes.
//
// band (C <= 4 where the span below fits in shared memory; every conv1_1):
// a tile is BM = 256 consecutive positions of the Wp-wide output grid of one
// image by 64 output channels (the two columns past W of each row are
// computed and not stored). Its operand lies in the contiguous span of
// BM + 2*Wp + 2 padded input pixels those positions touch, and for a fixed dy
// the 3C columns dy*3C ... dy*3C + 3C - 1 of position q are the 3C
// contiguous values from pixel q + dy*Wp on: the operand is read from the
// span at fixed offsets, with no division in the inner loop. What the first
// design (the gather route below) lost its time to, and what this does:
//   - the operand gathered one element at a time from device memory, with
//     integer divisions per element: here the span comes in as one bulk
//     copy (cp.async.bulk, 16-byte aligned, the few bytes past the last
//     16-byte boundary loaded by threads), each input byte once per tile;
//   - the weights reloaded by every block of 128 pixels: here a persistent
//     grid (at most 2 blocks per SM) loads w and the bias into shared memory
//     once per block and walks tiles;
//   - no overlap inside a block: here the span of the block's next tile is
//     in flight (a 2-stage ring, one mbarrier per stage) while this tile
//     computes and stores;
//   - narrow bf16 stores: here every store writes whole 128-byte lines.
//   f32:  FMA on an 8-position x 8-channel register tile per thread (the
//         channels cg*4 + {0..3} and 32 + cg*4 + {0..3}, so that 8 threads
//         write one line). Per dy a thread reads its 10C-value window of the
//         span once and uses it for all 3C columns: 27 x 64 FMAs per 90
//         scalar and 54 float4 shared-memory reads at C = 3. Where each
//         block has one tile (batch 1 at 256 px) stores go from the
//         registers: a warp store is 4 pixels x 128 bytes. Where blocks walk
//         more than one tile, the tile goes through a staging tile and out
//         by bulk copies (one per output row it touches, O <= 64 channels a
//         multiple of 4), left in flight while the block computes its next
//         tile: the plan's route 2.
//   bf16: mma.sync m16n8k16, K padded to 16 (32 at C = 3: two k16 steps).
//         The math is 0.23 us at the tensor cores' peak, so the choice is by
//         instructions and registers: the A fragments are built in registers
//         from 2-byte reads of the span (offsets computed once per thread),
//         the B fragments read as bf16 pairs packed once per block; wgmma
//         would need A in a 64-row warpgroup layout or a staged copy of the
//         operand for no gain in time. The tile goes through a shared-memory
//         staging tile and out in 16-byte stores, 8 threads a pixel's line.
// No atomics: two calls on the same inputs give the same bits.
//
// gather (every other shape: C > 4, or a span too large): the first design.
// A block owns BM = 128 output pixels of one image and BN output channels.
// It walks K = 9*C in slices; for each it gathers the [BM, slice] block of
// the im2col operand from the shifted input rows (column k = tap*C + c of
// pixel (y, x) is xpad[y + dy, x + dx, c]) into shared memory, with the
// matching [slice, BN] rows of w reshaped to [9C, O], and multiplies. Columns
// past K and pixels past the image are zero, so any C >= 1 and O >= 1 work.
//   f32:  FMA on an 8 x TN register tile per thread (256 threads, slices of 16).
//   bf16: mma.sync m16n8k16 with f32 accumulation (8 warps, each 32 pixels by
//         BN / 2 channels; slices of 32), fragments read with ldmatrix.
// The output is stored from the accumulators after the bias and ReLU, in
// 16-byte groups (f32) or channel pairs (bf16) where O allows it.

#include "hopper.cuh"

namespace {

using conv3x3::f32_col;
using conv3x3::smem_addr;
using namespace hopper;

// ----------------------------------------------------------- gather route
constexpr int BM = 128;  // output pixels per block (all in one image)
constexpr int NT = 256;  // threads per block

struct Im2colShape {
  int Wp, C, O, W, HW, K, rows, tiles;
};

// Row offset in the flattened padded image of column k of the operand.
__device__ __forceinline__ int tap_offset(int k, const Im2colShape& s, int* c) {
  const int t = k / s.C;
  *c = k - t * s.C;
  return (t / 3) * s.Wp + (t % 3);
}

// ---------------------------------------------------------------- f32 path
constexpr int BK_F32 = 16;

__device__ __forceinline__ int split_row(int t, int i) {
  // Rows i = 0..7 of a thread: t*4 + {0..3} and 64 + t*4 + {0..3}.
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

template <int TN>
__global__ void __launch_bounds__(NT)
conv3x3_im2col_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out,
                          Im2colShape s, int relu) {
  constexpr int BN = 16 * TN;
  __shared__ __align__(16) float As[BK_F32][BM];  // the operand's slice, As[k][m]
  __shared__ __align__(16) float Bs[BK_F32][BN];  // w[k][n]

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int p0 = (blockIdx.x - img * s.tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + (size_t)img * s.rows * s.C;
  const int ty = tid >> 4, tx = tid & 15;

  // Every slice, this thread gathers pixel m = tid % BM at columns tid / BM,
  // tid / BM + 2, ... of the slice.
  const int gm = tid % BM;
  const int gp = p0 + gm;
  const bool g_ok = gp < s.HW;
  const int g_base = g_ok ? (gp / s.W) * s.Wp + gp % s.W : 0;

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.K; k0 += BK_F32) {
#pragma unroll
    for (int kk = tid / BM; kk < BK_F32; kk += NT / BM) {
      const int k = k0 + kk;
      float v = 0.f;
      if (g_ok && k < s.K) {
        int c;
        const int row = g_base + tap_offset(k, s, &c);
        v = xb[(size_t)row * s.C + c];
      }
      As[kk][gm] = v;
    }
    for (int i = tid; i < BK_F32 * BN; i += NT) {
      const int kk = i / BN, n = i % BN;
      const int k = k0 + kk, o = n0 + n;
      Bs[kk][n] = (k < s.K && o < s.O) ? w[(size_t)k * s.O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK_F32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
      if constexpr (TN >= 4) {
#pragma unroll
        for (int gq = 0; gq < TN / 4; ++gq) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[k][gq * 64 + tx * 4]);
          b[gq * 4 + 0] = v.x;
          b[gq * 4 + 1] = v.y;
          b[gq * 4 + 2] = v.z;
          b[gq * 4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][f32_col<TN>(tx, j)];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float bcol[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + f32_col<TN>(tx, j);
    bcol[j] = n < s.O ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + split_row(ty, i);
    if (p >= s.HW) continue;
    float* orow = out + ((size_t)img * s.HW + p) * s.O;
    if constexpr (TN >= 4) {
      if ((s.O & 3) == 0) {  // whole float4 groups: n < O implies n + 3 < O
#pragma unroll
        for (int gq = 0; gq < TN / 4; ++gq) {
          const int n = n0 + gq * 64 + tx * 4;
          if (n < s.O)
            *reinterpret_cast<float4*>(orow + n) = make_float4(
                conv3x3::bias_relu(acc[i][gq * 4 + 0], bcol[gq * 4 + 0], relu),
                conv3x3::bias_relu(acc[i][gq * 4 + 1], bcol[gq * 4 + 1], relu),
                conv3x3::bias_relu(acc[i][gq * 4 + 2], bcol[gq * 4 + 2], relu),
                conv3x3::bias_relu(acc[i][gq * 4 + 3], bcol[gq * 4 + 3], relu));
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + f32_col<TN>(tx, j);
      if (n < s.O) orow[n] = conv3x3::bias_relu(acc[i][j], bcol[j], relu);
    }
  }
}

// --------------------------------------------------------------- bf16 path
constexpr int BK_BF16 = 32;
constexpr int A_LD = BK_BF16 + 8;  // operand row pitch in bf16: 80 bytes, ldmatrix conflict-free

// NI: n8 tiles per warp. Warps: 4 along the pixels (32 each) by 2 along the
// channels (NI * 8 each), so BN = 16 * NI.
template <int NI>
__global__ void __launch_bounds__(NT)
conv3x3_im2col_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           Im2colShape s, int relu) {
  constexpr int BN = 16 * NI;
  constexpr int B_LD = BN + 8;  // weight row pitch in bf16, ldmatrix conflict-free
  __shared__ __align__(16) __nv_bfloat16 As[BM][A_LD];       // the operand's slice, As[m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BK_BF16][B_LD];  // w[k][n]

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int p0 = (blockIdx.x - img * s.tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + (size_t)img * s.rows * s.C;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < s.K; k0 += BK_BF16) {
    for (int i = tid; i < BM * BK_BF16; i += NT) {
      const int m = i / BK_BF16, kk = i % BK_BF16;
      const int p = p0 + m, k = k0 + kk;
      __nv_bfloat16 v = zero;
      if (p < s.HW && k < s.K) {
        int c;
        const int row = (p / s.W) * s.Wp + p % s.W + tap_offset(k, s, &c);
        v = xb[(size_t)row * s.C + c];
      }
      As[m][kk] = v;
    }
    for (int i = tid; i < BK_BF16 * BN; i += NT) {
      const int kk = i / BN, n = i % BN;
      const int k = k0 + kk, o = n0 + n;
      Bs[kk][n] = (k < s.K && o < s.O) ? w[(size_t)k * s.O + o] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_BF16; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        conv3x3::ldmatrix_x4(a[mi], &As[wm * 32 + mi * 16 + lrow][kk + lcol]);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];  // b[0..1]: n tile 2*np, b[2..3]: n tile 2*np + 1
        conv3x3::ldmatrix_x4_trans(b, &Bs[kk + lrow][wn * (NI * 8) + np * 16 + lcol]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          conv3x3::mma_bf16_16816(acc[mi][2 * np], a[mi], b[0], b[1]);
          conv3x3::mma_bf16_16816(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // Accumulator fragment: e = 0,1 -> row g, columns t4*2 + {0,1}; e = 2,3 ->
  // row g + 8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 32 + mi * 16 + g + half * 8;
      if (p >= s.HW) continue;
      __nv_bfloat16* orow = out + ((size_t)img * s.HW + p) * s.O;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * (NI * 8) + ni * 8 + t4 * 2;
        const float b0 = n < s.O ? bias[n] : 0.f, b1 = n + 1 < s.O ? bias[n + 1] : 0.f;
        conv3x3::store_bf16_pair(orow, n, s.O,
                                 conv3x3::bias_relu(acc[mi][ni][half * 2 + 0], b0, relu),
                                 conv3x3::bias_relu(acc[mi][ni][half * 2 + 1], b1, relu));
      }
    }
}

// ------------------------------------------------------------- band route
constexpr int BAND_BM = 256;  // positions of the Wp-wide output grid per tile
constexpr int BAND_BN = 64;   // output channels per tile
constexpr int BAND_NT = 256;  // threads per block
constexpr int BAND_MAX_C = 4;
constexpr int STAGING_LD = BAND_BN + 8;  // bf16 staging row pitch: conflict-free pair writes

struct BandShape {
  int Hp, Wp, C, O, H, W;
  int M;            // H * Wp: positions of an image's output grid
  int qtiles;       // tiles per image along the positions
  int nchunks;      // 64-channel chunks of O
  int tiles;        // B * qtiles * nchunks
  int span;         // BAND_BM + 2 * Wp + 2: input pixels a tile reads
  int stage_bytes;  // one stage of the ring: the span, 16 bytes of lead, 128-byte aligned
  int wpitch;       // f32: floats per weight row; bf16: words per packed weight row
  int bulk_out;     // f32: the tile goes out by bulk copies from a staging tile [BAND_BM][O]
};

__host__ __device__ __forceinline__ int round_up(int v, int a) { return (v + a - 1) / a * a; }

BandShape band_shape(int B, int Hp, int Wp, int C, int O, int elt, int bulk_out) {
  BandShape s;
  s.Hp = Hp;
  s.Wp = Wp;
  s.C = C;
  s.O = O;
  s.H = Hp - 2;
  s.W = Wp - 2;
  s.M = s.H * Wp;
  s.qtiles = (s.M + BAND_BM - 1) / BAND_BM;
  s.nchunks = (O + BAND_BN - 1) / BAND_BN;
  s.tiles = B * s.qtiles * s.nchunks;
  s.span = BAND_BM + 2 * Wp + 2;
  s.stage_bytes = round_up(s.span * C * elt + 16, 128);
  s.wpitch = s.nchunks * BAND_BN + (elt == 2 ? 8 : 0);
  s.bulk_out = bulk_out;
  return s;
}

// Dynamic shared memory of a band block: two mbarriers (128 bytes), the two
// stages, the weights, the bias and, in bf16, the staging tile.
// ops/cuda/conv3x3_flat.py::band_smem_bytes computes the same to route.
size_t band_smem_bytes(const BandShape& s, int elt) {
  const int ks = (9 * s.C + 15) / 16;
  const size_t weights = elt == 2 ? (size_t)ks * 8 * s.wpitch * 4 : (size_t)9 * s.C * s.wpitch * 4;
  const size_t staging = elt == 2    ? (size_t)BAND_BM * STAGING_LD * 2
                         : s.bulk_out ? (size_t)BAND_BM * s.O * 4
                                      : 0;
  return 128 + 2 * (size_t)s.stage_bytes + weights + (size_t)s.nchunks * BAND_BN * 4 + staging;
}

// One bulk copy (no tensor map) of `bytes` (a multiple of 16) from global to
// shared memory, both 16-byte aligned, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from shared to global memory,
// both 16-byte aligned, in the issuing thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

struct BandTile {
  int img, q0, n0;
};

__device__ __forceinline__ BandTile band_tile(int t, const BandShape& s) {
  BandTile r;
  r.n0 = (t % s.nchunks) * BAND_BN;
  t /= s.nchunks;
  r.q0 = (t % s.qtiles) * BAND_BM;
  r.img = t / s.qtiles;
  return r;
}

// Where tile `t`'s span lies: it starts `lead` elements into its stage (the
// bulk copy starts at the 16-byte boundary at or before it), the bulk copy
// is `bulk` bytes from element `from` of x, and the `tail` elements after
// it (past the last 16-byte boundary of the span, clipped to the image) are
// loaded by threads from element `from + bulk / elt`.
struct Span {
  size_t from;
  int lead, bulk, tail;
};

template <typename T>
__device__ __forceinline__ Span span_of(const BandTile& tl, const BandShape& s) {
  const size_t image = (size_t)s.Hp * s.Wp * s.C;
  const size_t e0 = (size_t)tl.img * image + (size_t)tl.q0 * s.C;
  const size_t end = (size_t)(tl.img + 1) * image;
  const size_t e1 = e0 + (size_t)s.span * s.C < end ? e0 + (size_t)s.span * s.C : end;
  const size_t b0 = e0 * sizeof(T), b1 = e1 * sizeof(T);
  const size_t a0 = b0 & ~(size_t)15, a1 = b1 & ~(size_t)15;
  Span sp;
  sp.from = a0 / sizeof(T);
  sp.lead = static_cast<int>((b0 - a0) / sizeof(T));
  sp.bulk = static_cast<int>(a1 - a0);
  sp.tail = static_cast<int>((b1 - a1) / sizeof(T));
  return sp;
}

// Thread 0 starts tile t's span into `stage`, counted on `bar`.
template <typename T>
__device__ __forceinline__ void issue_span(const T* x, int t, const BandShape& s,
                                           unsigned char* stage, uint64_t* bar) {
  const Span sp = span_of<T>(band_tile(t, s), s);
  mbar_expect(bar, sp.bulk);
  if (sp.bulk > 0) bulk_load(stage, x + sp.from, sp.bulk, bar);
}

// Every thread: wait for the tile's span in `stage` (the threads below the
// tail count load the tail first) and return where it lies.
template <typename T>
__device__ __forceinline__ Span await_span(const T* x, const BandTile& tl, const BandShape& s,
                                           T* stage, uint64_t* bar, int use) {
  const Span sp = span_of<T>(tl, s);
  if (static_cast<int>(threadIdx.x) < sp.tail) {
    stage[sp.bulk / sizeof(T) + threadIdx.x] = x[sp.from + sp.bulk / sizeof(T) + threadIdx.x];
    // The next bulk copy into this stage must see this write ordered before it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  mbar_wait(bar, use & 1);
  __syncthreads();
  return sp;
}

__device__ __forceinline__ void band_init_barriers(uint64_t* full) {
  if (threadIdx.x == 0) {
    mbar_init(full);
    mbar_init(full + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

template <int C>
__global__ void __launch_bounds__(BAND_NT, 2)
im2col_band_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out, BandShape s,
                       int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 128;
  float* ws = reinterpret_cast<float*>(stages + 2 * s.stage_bytes);  // [9C][wpitch]
  float* bs = ws + 9 * C * s.wpitch;
  float* staging = bs + s.nchunks * BAND_BN;  // [BAND_BM][O] where bulk_out
  const int tid = threadIdx.x;

  band_init_barriers(full);
  for (int i = tid; i < 9 * C * s.wpitch; i += BAND_NT) {
    const int k = i / s.wpitch, n = i - k * s.wpitch;
    ws[i] = n < s.O ? w[(size_t)k * s.O + n] : 0.f;
  }
  for (int n = tid; n < s.nchunks * BAND_BN; n += BAND_NT) bs[n] = n < s.O ? bias[n] : 0.f;
  __syncthreads();

  // Thread (pg, cg): positions pg*8 + {0..7} of the tile, channels
  // cg*4 + {0..3} and 32 + cg*4 + {0..3} of its chunk.
  const int pg = tid >> 3, cg = tid & 7;
  int t = blockIdx.x;
  if (tid == 0 && t < s.tiles) issue_span(x, t, s, stages, full);
  for (int it = 0; t < s.tiles; t += gridDim.x, ++it) {
    const int st = it & 1;
    if (tid == 0 && t + (int)gridDim.x < s.tiles)
      issue_span(x, t + gridDim.x, s, stages + (st ^ 1) * s.stage_bytes, full + (st ^ 1));
    const BandTile tl = band_tile(t, s);
    float* stage = reinterpret_cast<float*>(stages + st * s.stage_bytes);
    const Span sp = await_span(x, tl, s, stage, full + st, it >> 1);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const float* base = stage + sp.lead + pg * 8 * C;
    const float* wcol = ws + tl.n0 + cg * 4;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float win[10 * C];  // pixels pg*8 .. pg*8 + 9 of row dy of the window
      const float* r = base + dy * s.Wp * C;
#pragma unroll
      for (int e = 0; e < 10 * C; ++e) win[e] = r[e];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = (dy * 3 + dx) * C + c;
          const float4 w0 = *reinterpret_cast<const float4*>(wcol + k * s.wpitch);
          const float4 w1 = *reinterpret_cast<const float4*>(wcol + k * s.wpitch + 32);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = win[(i + dx) * C + c];
            acc[i][0] = fmaf(a, w0.x, acc[i][0]);
            acc[i][1] = fmaf(a, w0.y, acc[i][1]);
            acc[i][2] = fmaf(a, w0.z, acc[i][2]);
            acc[i][3] = fmaf(a, w0.w, acc[i][3]);
            acc[i][4] = fmaf(a, w1.x, acc[i][4]);
            acc[i][5] = fmaf(a, w1.y, acc[i][5]);
            acc[i][6] = fmaf(a, w1.z, acc[i][6]);
            acc[i][7] = fmaf(a, w1.w, acc[i][7]);
          }
        }
    }

    float bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = bs[tl.n0 + (j >> 2) * 32 + cg * 4 + (j & 3)];
    if (s.bulk_out) {
      // Through the staging tile [position][O], then one bulk copy per output
      // row the tile touches, issued by thread 0 and left in flight while the
      // block goes on to its next tile.
      if (tid == 0) bulk_wait_read<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = h * 32 + cg * 4;
          if (n < s.O)
            *reinterpret_cast<float4*>(staging + (pg * 8 + i) * s.O + n) = make_float4(
                conv3x3::bias_relu(acc[i][h * 4 + 0], bv[h * 4 + 0], relu),
                conv3x3::bias_relu(acc[i][h * 4 + 1], bv[h * 4 + 1], relu),
                conv3x3::bias_relu(acc[i][h * 4 + 2], bv[h * 4 + 2], relu),
                conv3x3::bias_relu(acc[i][h * 4 + 3], bv[h * 4 + 3], relu));
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        const int qend = min(tl.q0 + BAND_BM, s.M);
        for (int y = tl.q0 / s.Wp; y * s.Wp < qend; ++y) {
          const int x0 = max(tl.q0 - y * s.Wp, 0), x1 = min(qend - y * s.Wp, s.W);
          if (x0 < x1)
            bulk_store(out + (((size_t)tl.img * s.H + y) * s.W + x0) * s.O,
                       staging + (y * s.Wp + x0 - tl.q0) * s.O, (x1 - x0) * s.O * 4);
        }
        bulk_commit();
      }
    } else {
      int q = tl.q0 + pg * 8;
      int y = q / s.Wp, xx = q - y * s.Wp;
#pragma unroll
      for (int i = 0; i < 8; ++i, ++q) {
        if (q < s.M && xx < s.W) {
          float* orow = out + (((size_t)tl.img * s.H + y) * s.W + xx) * s.O;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = tl.n0 + h * 32 + cg * 4;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = conv3x3::bias_relu(acc[i][h * 4 + j], bv[h * 4 + j], relu);
            if ((s.O & 3) == 0) {  // whole float4 groups: n < O implies n + 3 < O
              if (n < s.O)
                *reinterpret_cast<float4*>(orow + n) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (n + j < s.O) orow[n + j] = v[j];
            }
          }
        }
        if (++xx == s.Wp) {
          xx = 0;
          ++y;
        }
      }
    }
    __syncthreads();  // every read of this stage is done before it is filled again
  }
  if (tid == 0) bulk_wait<0>();  // the staging tile stays until the last copy is done
}

template <int C>
__global__ void __launch_bounds__(BAND_NT, 2)
im2col_band_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        BandShape s, int relu) {
  constexpr int K = 9 * C, KS = (K + 15) / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 128;
  // Weights as bf16 pairs along k: wp[kp][n] = (w[2kp][n], w[2kp + 1][n]).
  uint32_t* wp = reinterpret_cast<uint32_t*>(stages + 2 * s.stage_bytes);
  float* bs = reinterpret_cast<float*>(wp + KS * 8 * s.wpitch);
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(bs + s.nchunks * BAND_BN);
  const unsigned short* wbits = reinterpret_cast<const unsigned short*>(w);
  const int tid = threadIdx.x;

  band_init_barriers(full);
  for (int i = tid; i < KS * 8 * s.wpitch; i += BAND_NT) {
    const int kp = i / s.wpitch, n = i - kp * s.wpitch;
    const bool n_ok = n < s.O;
    const uint32_t lo = (n_ok && 2 * kp < K) ? wbits[(size_t)(2 * kp) * s.O + n] : 0u;
    const uint32_t hi = (n_ok && 2 * kp + 1 < K) ? wbits[(size_t)(2 * kp + 1) * s.O + n] : 0u;
    wp[i] = lo | (hi << 16);
  }
  for (int n = tid; n < s.nchunks * BAND_BN; n += BAND_NT) bs[n] = n < s.O ? bias[n] : 0.f;
  __syncthreads();

  // Warp w: positions w*32 .. w*32 + 31 (two m16 tiles) by the chunk's 64
  // channels (eight n8 tiles). Column k of the operand at position q is
  // element q*C + off(k) of the span, off(k) = (k / 3C)*Wp*C + k % 3C; this
  // thread's columns are ks*16 + h*8 + t4*2 + {0, 1}.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  int off[KS][2][2];
  bool col_ok[KS][2][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = ks * 16 + h * 8 + t4 * 2 + e;
        col_ok[ks][h][e] = k < K;
        off[ks][h][e] = k < K ? (k / (3 * C)) * s.Wp * C + k % (3 * C) : 0;
      }

  int t = blockIdx.x;
  if (tid == 0 && t < s.tiles) issue_span(x, t, s, stages, full);
  for (int it = 0; t < s.tiles; t += gridDim.x, ++it) {
    const int st = it & 1;
    if (tid == 0 && t + (int)gridDim.x < s.tiles)
      issue_span(x, t + gridDim.x, s, stages + (st ^ 1) * s.stage_bytes, full + (st ^ 1));
    const BandTile tl = band_tile(t, s);
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(stages + st * s.stage_bytes);
    const Span sp = await_span(x, tl, s, stage, full + st, it >> 1);
    const unsigned short* band = reinterpret_cast<const unsigned short*>(stage) + sp.lead;

    // A fragments (m16n8k16, row-major): a[mt][ks][h * 2 + rr] holds row
    // g + 8 * rr of m tile mt, columns ks*16 + h*8 + t4*2 + {0, 1}.
    uint32_t a[2][KS][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const unsigned short* r = band + (warp * 32 + mt * 16 + rr * 8 + g) * C;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo = col_ok[ks][h][0] ? r[off[ks][h][0]] : 0u;
            const uint32_t hi = col_ok[ks][h][1] ? r[off[ks][h][1]] : 0u;
            a[mt][ks][h * 2 + rr] = lo | (hi << 16);
          }
      }
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      // B fragment (col-major): column n = g of n tile nt, rows t4*2 + {0, 1}
      // and t4*2 + 8 + {0, 1} of each k16 step.
      const uint32_t* wn = wp + tl.n0 + nt * 8 + g;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t b0 = wn[(ks * 8 + t4) * s.wpitch];
        const uint32_t b1 = wn[(ks * 8 + 4 + t4) * s.wpitch];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) conv3x3::mma_bf16_16816(acc[mt][nt], a[mt][ks], b0, b1);
      }
    }

    // Bias, ReLU and the one rounding into the staging tile [position][64].
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + t4 * 2;
      const float b0 = bs[tl.n0 + col], b1 = bs[tl.n0 + col + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = warp * 32 + mt * 16 + rr * 8 + g;
          *reinterpret_cast<__nv_bfloat162*>(staging + row * STAGING_LD + col) =
              __floats2bfloat162_rn(conv3x3::bias_relu(acc[mt][nt][rr * 2 + 0], b0, relu),
                                    conv3x3::bias_relu(acc[mt][nt][rr * 2 + 1], b1, relu));
        }
    }
    __syncthreads();
    if ((s.O & 7) == 0) {
      // 16-byte pieces: thread i stores piece i & 7 of positions i / 8 + 32j,
      // so 8 threads write one position's 128-byte line.
      const int piece = tid & 7, n = tl.n0 + piece * 8;
      int q = tl.q0 + (tid >> 3);
      int y = q / s.Wp, xx = q - y * s.Wp;
#pragma unroll
      for (int j = 0; j < BAND_BM / 32; ++j) {
        if (q < s.M && xx < s.W && n < s.O) {
          const int row = (tid >> 3) + 32 * j;
          *reinterpret_cast<uint4*>(out + (((size_t)tl.img * s.H + y) * s.W + xx) * s.O + n) =
              *reinterpret_cast<const uint4*>(staging + row * STAGING_LD + piece * 8);
        }
        q += 32;
        xx += 32;
        while (xx >= s.Wp) {
          xx -= s.Wp;
          ++y;
        }
      }
    } else {
      for (int i = tid; i < BAND_BM * BAND_BN; i += BAND_NT) {
        const int row = i / BAND_BN, col = i % BAND_BN;
        const int q = tl.q0 + row, y = q / s.Wp, xx = q - y * s.Wp, n = tl.n0 + col;
        if (q < s.M && xx < s.W && n < s.O)
          out[(((size_t)tl.img * s.H + y) * s.W + xx) * s.O + n] = staging[row * STAGING_LD + col];
      }
    }
    __syncthreads();  // the stage and the staging tile are free again
  }
}

template <int C>
int band_f32(const void* x, const void* w, const void* bias, void* out, const BandShape& s,
             int relu, int blocks, cudaStream_t st) {
  static hopper::Granted granted;
  const size_t bytes = band_smem_bytes(s, 4);
  const cudaError_t err = hopper::allow_smem(im2col_band_f32_kernel<C>, bytes, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  im2col_band_f32_kernel<C><<<blocks, BAND_NT, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), s, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int band_bf16(const void* x, const void* w, const void* bias, void* out, const BandShape& s,
              int relu, int blocks, cudaStream_t st) {
  static hopper::Granted granted;
  const size_t bytes = band_smem_bytes(s, 2);
  const cudaError_t err = hopper::allow_smem(im2col_band_bf16_kernel<C>, bytes, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  im2col_band_bf16_kernel<C><<<blocks, BAND_NT, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), s, relu);
  return static_cast<int>(cudaGetLastError());
}

Im2colShape make_shape(int Hp, int Wp, int C, int O) {
  Im2colShape s;
  s.Wp = Wp;
  s.C = C;
  s.O = O;
  s.W = Wp - 2;
  s.HW = (Hp - 2) * (Wp - 2);
  s.K = 9 * C;
  s.rows = Hp * Wp;
  s.tiles = (s.HW + BM - 1) / BM;
  return s;
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int bn, const void* x, const void* w, const void* bias, void* out,
           int B, const Im2colShape& s, int relu, cudaStream_t st) {
  const dim3 grid(B * s.tiles, (s.O + bn - 1) / bn);
  kernel<<<grid, NT, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                              static_cast<const float*>(bias), static_cast<T*>(out), s, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_conv3x3_im2col_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] and w [3, 3, C, O] f32, bias [O] f32, out [B, Hp-2, Wp-2, O]
// f32. route 0 takes the gather route; 1 the band route on `blocks`
// persistent blocks (C <= 4), storing from the registers; 2 (f32, O <= 64, a
// multiple of 4) the band route with bulk stores from a staging tile.
// Returns a cudaError_t (0 on success).
int stx_conv3x3_im2col_f32(const void* x, const void* w, const void* bias, void* out, int B,
                           int Hp, int Wp, int C, int O, int relu, int route, int blocks,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route) {
    // Bulk stores need a pixel's O channels to be one 16-byte multiple.
    if (C < 1 || C > BAND_MAX_C || blocks < 1 || (route == 2 && (O > BAND_BN || O % 4)))
      return static_cast<int>(cudaErrorInvalidValue);
    const BandShape s = band_shape(B, Hp, Wp, C, O, 4, route == 2);
    if (C == 1) return band_f32<1>(x, w, bias, out, s, relu, blocks, st);
    if (C == 2) return band_f32<2>(x, w, bias, out, s, relu, blocks, st);
    if (C == 3) return band_f32<3>(x, w, bias, out, s, relu, blocks, st);
    return band_f32<4>(x, w, bias, out, s, relu, blocks, st);
  }
  const Im2colShape s = make_shape(Hp, Wp, C, O);
  if (O > 64) return launch<float>(conv3x3_im2col_f32_kernel<8>, 128, x, w, bias, out, B, s, relu, st);
  if (O > 32) return launch<float>(conv3x3_im2col_f32_kernel<4>, 64, x, w, bias, out, B, s, relu, st);
  if (O > 16) return launch<float>(conv3x3_im2col_f32_kernel<2>, 32, x, w, bias, out, B, s, relu, st);
  return launch<float>(conv3x3_im2col_f32_kernel<1>, 16, x, w, bias, out, B, s, relu, st);
}

// As stx_conv3x3_im2col_f32 with x, w and out in bf16 (bias stays f32).
int stx_conv3x3_im2col_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                            int Hp, int Wp, int C, int O, int relu, int route, int blocks,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route) {
    if (C < 1 || C > BAND_MAX_C || blocks < 1 || route != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const BandShape s = band_shape(B, Hp, Wp, C, O, 2, 0);
    if (C == 1) return band_bf16<1>(x, w, bias, out, s, relu, blocks, st);
    if (C == 2) return band_bf16<2>(x, w, bias, out, s, relu, blocks, st);
    if (C == 3) return band_bf16<3>(x, w, bias, out, s, relu, blocks, st);
    return band_bf16<4>(x, w, bias, out, s, relu, blocks, st);
  }
  const Im2colShape s = make_shape(Hp, Wp, C, O);
  using bf16 = __nv_bfloat16;
  if (O > 64) return launch<bf16>(conv3x3_im2col_bf16_kernel<8>, 128, x, w, bias, out, B, s, relu, st);
  if (O > 32) return launch<bf16>(conv3x3_im2col_bf16_kernel<4>, 64, x, w, bias, out, B, s, relu, st);
  return launch<bf16>(conv3x3_im2col_bf16_kernel<2>, 32, x, w, bias, out, B, s, relu, st);
}

}  // extern "C"
