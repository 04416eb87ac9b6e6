// 3x3 VALID convolution + bias (+ReLU) of a pre-padded NHWC image, no
// statistics: the shift-slice form.
//
// Replaces the TPU kernel styletransfer_tpu/ops/pallas/conv3x3.py
// (conv3x3_flat -> _flat_kernel): out[b, y, x, o] =
//   sum_{dy,dx,c} xpad[b, y+dy, x+dx, c] * w[dy, dx, c, o] + bias[o]
// with f32 accumulation and the bias added in f32 before the one rounding to
// the output type. The port runs every 3x3 conv of the VGG tower with C >= 32
// on it, and every input gradient of those convs (the same function on the
// zero-padded output gradient with the kernel flipped in space and its
// channels transposed).
//
// What bounds it on an H100: the Gatys tower's convs (64 to 256 px at batch
// 1, C and O from 64 to 256) do 2.4 to 4.8 GFLOP on 4 to 34 MB. f32 runs on
// the CUDA cores (67 TFLOP/s; TF32 would drift from the f32 reference) and is
// bound by operations. bf16 has the tensor cores (989 TFLOP/s), so at these
// shapes it is bound by what reaches shared memory: each block re-reads the
// weights of its channels and a span up to 5x its positions, and per-thread
// cp.async copies left about 10 bytes a cycle per SM in flight. The conv of
// C = 64 to O = 3 (conv1_1's input gradient) is bound by bytes. At batch 1
// the 64 and 128 px convs have too few 128-position tiles to fill 132 SMs.
//
// Design: the flattened padded image is a [Hp*Wp, C] matrix, and a tap
// (dy, dx) of output position q of the Wp-wide output grid reads input row
// q + dy*Wp + dx. A block owns BM consecutive positions of one image and BN
// output channels. Per chunk of channels it stages the one contiguous span of
// BM + 2*Wp + 2 input rows those positions touch, with the weights of all
// nine taps, and reads each tap as a window of the span shifted by
// dy*Wp + dx: an input element is loaded from memory once per block and used
// by all nine taps. Chunks arrive through a 2-stage ring: chunk k+1 loads
// while chunk k computes. The kernel masks rows past the end of the image
// and channels past C itself (zero-filled copies; any C >= 1 and O >= 1);
// the two garbage columns of each row are computed and not stored.
//   f32:  cp.async ring. FMA on an 8 x TN register tile per thread, 8
//         channels per chunk, the span laid out [row][8] as cp.async writes
//         it. A thread's 8 positions are consecutive, so the three dx taps of
//         one dy reuse 10 float2 reads (two channels each) from shared memory.
//   bf16: TMA ring (one thread issues the copies, an mbarrier per stage
//         counts the bytes in; element copies by every thread where C or O
//         is not a multiple of 8). wgmma m64nBNk16 (sm_90a) with f32
//         accumulators, two warpgroups of 64 positions, 16 channels per
//         chunk, one wgmma per tap. A comes from registers: a tap's window can
//         start at any row of the span, which a shared-memory descriptor
//         cannot address, so each warp loads its 16 rows with ldmatrix at the
//         shifted rows (the m16n8k16 A fragment is the wgmma one). B, the
//         weights [tap][k][n] with n contiguous, is read by descriptor, N-major
//         in TMA's 128-byte swizzle. Blocks start their chunk loop at
//         different chunks (by the tile's place in its image), so that they
//         do not all fetch one chunk's weights at once.
// The wrapper (ops/cuda/conv3x3_flat.py::flat_plan) picks BM and BN per
// shape and, where even its smallest tile gives fewer blocks than SMs, splits
// the chunks over `split` blocks. The blocks of a split write their f32
// partial tiles to a workspace; the last to finish (a counter per tile, the
// only atomic) adds them in split order, then adds the bias, applies the
// ReLU and rounds once. So a call is one kernel launch and its result is the
// same bit for bit from run to run; and since the plan's tile and split do
// not depend on the batch, an image's result does not either.

#include "hopper.cuh"

namespace {

using conv3x3::smem_addr;
using namespace hopper;

struct FlatShape {
  int Wp, C, O, H, W;
  int M;       // H * Wp: positions of the output grid
  int rows;    // Hp * Wp: rows of the flattened input
  int span;    // BM + 2 * Wp + 2: input rows that one block reads
  int tiles;   // blocks per image along the positions
  int chunks;  // channel chunks per split
};

// 16 bytes (or 4) from global to shared memory, the bytes past src_bytes
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int STAGES = 2;  // ring depth (cp.async in f32, TMA in bf16)

// The split-K epilogue. Every block of a split stores its partial sums in
// its own register order; the last block of the tile to arrive reads all of
// them back in split order into acc and returns true, the others return
// false. The counter is left at 0 for the next launch.
template <int NT, int NACC>
__device__ bool reduce_split(float (&acc)[NACC], float* ws, int* counters, int split) {
  static_assert(NACC % 4 == 0, "partials are stored as float4");
  __shared__ int last;
  const int tid = threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float4* part = reinterpret_cast<float4*>(ws) + (size_t)tile * split * (NACC / 4) * NT;
#pragma unroll
  for (int e = 0; e < NACC / 4; ++e)
    __stcg(part + ((size_t)blockIdx.z * (NACC / 4) + e) * NT + tid,
           make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]));
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == split - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int e = 0; e < NACC / 4; ++e) {
    float4 v = __ldcg(part + (size_t)e * NT + tid);
    for (int sp = 1; sp < split; ++sp) {
      const float4 u = __ldcg(part + ((size_t)sp * (NACC / 4) + e) * NT + tid);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    acc[4 * e] = v.x;
    acc[4 * e + 1] = v.y;
    acc[4 * e + 2] = v.z;
    acc[4 * e + 3] = v.w;
  }
  if (tid == 0) counters[tile] = 0;
  return true;
}

// ---------------------------------------------------------------- f32 path
constexpr int BK_F32 = 8;  // channels per chunk: one 32-byte span row

// Offset in floats of span row r. PAD adds 16 bytes after every 8 rows, for
// tiles whose threads in a warp read rows 8 apart (BN = TN: one thread per
// row group), which would otherwise all land on one bank.
template <bool PAD>
__host__ __device__ __forceinline__ int f32_row(int r) {
  return r * BK_F32 + (PAD ? (r >> 3) * 4 : 0);
}
template <bool PAD>
__host__ __device__ __forceinline__ int f32_stage_floats(int span, int BN) {
  return f32_row<PAD>(span) + 4 + 9 * BK_F32 * BN;
}

template <int BM, int BN, int TN>
__global__ void __launch_bounds__(BM * BN / (8 * TN))
conv3x3_flat_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out,
                        FlatShape s, int relu, float* ws, int* counters) {
  constexpr int NT = BM * BN / (8 * TN);  // threads: BM / 8 along the positions
  constexpr int NX = BN / TN;             // threads along the channels
  constexpr bool PAD = NX == 1;
  static_assert(TN == 4 || TN == 8, "B is read as float4 groups");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int span_floats = f32_row<PAD>(s.span) + 4;
  const int stage_floats = f32_stage_floats<PAD>(s.span, BN);

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int q0 = (blockIdx.x - img * s.tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + (size_t)img * s.rows * s.C;
  const int ty = tid / NX, tx = tid % NX;
  const bool vec_x = (s.C & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w = (s.O & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  auto load = [&](int chunk, int stage) {
    float* As = smem + stage * stage_floats;  // As[row][k]
    float* Bs = As + span_floats;             // Bs[tap][k][n]
    const int c0 = chunk * BK_F32;
    if (vec_x) {
      for (int i = tid; i < s.span * 2; i += NT) {
        const int r = i >> 1, k = (i & 1) * 4;
        const int g = q0 + r, c = c0 + k;
        const bool ok = g < s.rows && c < s.C;
        cp_async16(As + f32_row<PAD>(r) + k, ok ? xb + (size_t)g * s.C + c : x, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < s.span * BK_F32; i += NT) {
        const int r = i / BK_F32, k = i % BK_F32;
        const int g = q0 + r, c = c0 + k;
        const bool ok = g < s.rows && c < s.C;
        cp_async4(As + f32_row<PAD>(r) + k, ok ? xb + (size_t)g * s.C + c : x, ok ? 4 : 0);
      }
    }
    if (vec_w) {
      for (int i = tid; i < 9 * BK_F32 * (BN / 4); i += NT) {
        const int n = (i % (BN / 4)) * 4, tk = i / (BN / 4);  // tk = tap * 8 + k
        const int c = c0 + tk % BK_F32, o = n0 + n;
        const bool ok = c < s.C && o < s.O;
        cp_async16(Bs + tk * BN + n, ok ? w + ((size_t)(tk / BK_F32) * s.C + c) * s.O + o : w,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < 9 * BK_F32 * BN; i += NT) {
        const int n = i % BN, tk = i / BN;
        const int c = c0 + tk % BK_F32, o = n0 + n;
        const bool ok = c < s.C && o < s.O;
        cp_async4(Bs + i, ok ? w + ((size_t)(tk / BK_F32) * s.C + c) * s.O + o : w, ok ? 4 : 0);
      }
    }
  };

  float acc[8 * TN];
#pragma unroll
  for (int i = 0; i < 8 * TN; ++i) acc[i] = 0.f;

  const int chunk0 = blockIdx.z * s.chunks;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < s.chunks) load(chunk0 + st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < s.chunks; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kc has landed; every thread is done with kc - 1
    if (kc + STAGES - 1 < s.chunks) load(chunk0 + kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* As = smem + (kc % STAGES) * stage_floats;
    const float* Bs = As + span_floats;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
      const int base = ty * 8 + dy * s.Wp;
#pragma unroll 1
      for (int kp = 0; kp < BK_F32 / 2; ++kp) {
        float2 a[10];
#pragma unroll
        for (int r = 0; r < 10; ++r)
          a[r] = *reinterpret_cast<const float2*>(As + f32_row<PAD>(base + r) + 2 * kp);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* br = Bs + ((dy * 3 + dx) * BK_F32 + 2 * kp + kk) * BN + tx * 4;
            float b[TN];
#pragma unroll
            for (int gq = 0; gq < TN / 4; ++gq) {
              const float4 v = *reinterpret_cast<const float4*>(br + gq * 4 * NX);
              b[gq * 4 + 0] = v.x;
              b[gq * 4 + 1] = v.y;
              b[gq * 4 + 2] = v.z;
              b[gq * 4 + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float av = kk ? a[i + dx].y : a[i + dx].x;
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i * TN + j] = fmaf(av, b[j], acc[i * TN + j]);
            }
          }
      }
    }
  }
  if (gridDim.z > 1 && !reduce_split<NT, 8 * TN>(acc, ws, counters, gridDim.z)) return;

  // Column j of the thread: four adjacent channels per group of 4 * NX.
  float bcol[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + (j >> 2) * 4 * NX + tx * 4 + (j & 3);
    bcol[j] = n < s.O ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + ty * 8 + i;
    if (q >= s.M) break;
    const int y = q / s.Wp, xx = q - y * s.Wp;
    if (xx >= s.W) continue;  // one of the two garbage columns of the row
    float* orow = out + (((size_t)img * s.H + y) * s.W + xx) * s.O;
#pragma unroll
    for (int gq = 0; gq < TN / 4; ++gq) {
      const int n = n0 + gq * 4 * NX + tx * 4;
      const float* a4 = acc + i * TN + gq * 4;
      const float* b4 = bcol + gq * 4;
      if ((s.O & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        if (n < s.O)  // whole float4 groups: n < O implies n + 3 < O
          *reinterpret_cast<float4*>(orow + n) = make_float4(
              conv3x3::bias_relu(a4[0], b4[0], relu), conv3x3::bias_relu(a4[1], b4[1], relu),
              conv3x3::bias_relu(a4[2], b4[2], relu), conv3x3::bias_relu(a4[3], b4[3], relu));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < s.O) orow[n + e] = conv3x3::bias_relu(a4[e], b4[e], relu);
      }
    }
  }
}

// --------------------------------------------------------------- bf16 path
constexpr int BK_BF16 = 16;    // channels per chunk: the k of one wgmma
constexpr int BM_BF16 = 128;   // positions per block: two warpgroups of 64
constexpr int NT_BF16 = 256;   // threads per block
constexpr int BOX_ROWS = 256;  // span rows per TMA box (the most a box holds)

// The stage layout, the same whichever loader fills it (all offsets in
// bf16 elements from a 1024-byte aligned stage):
//   span: BOX_ROWS-row boxes of 32-byte rows, 16-byte halves swizzled as
//         TMA's 32-byte swizzle writes them (half h of row r at h ^ bit 2
//         of r), so that ldmatrix's eight rows hit eight bank groups;
//   B:    per tap [16 k][BN n]. BN >= 64: 64-channel atoms of 16 rows of
//         128 bytes, 16-byte pieces swizzled by k % 8 (TMA's 128-byte
//         swizzle, the wgmma B128 N-major layout); BN = 8: one 8-row core
//         matrix per 8 k (no swizzle).
__host__ __device__ __forceinline__ int bf16_span_elems(int span) {
  return (span + BOX_ROWS - 1) / BOX_ROWS * BOX_ROWS * BK_BF16;
}
__host__ __device__ __forceinline__ int bf16_stage_bytes(int span, int BN) {
  return (bf16_span_elems(span) + 9 * BK_BF16 * BN) * 2;
}
__device__ __forceinline__ int a_swz(int r, int k) {
  return r * BK_BF16 + ((((k >> 3) ^ (r >> 2)) & 1) << 3) + (k & 7);
}
template <int BN>
__device__ __forceinline__ int b_swz(int t, int k, int n) {
  if constexpr (BN < 64) return (t * BK_BF16 + k) * BN + n;
  return t * BK_BF16 * BN + (n >> 6) * 1024 + k * 64 + ((((n >> 3) ^ k) & 7) << 3) + (n & 7);
}

// Two warpgroups of 64 positions each, BN channels; at most 128 registers
// a thread (two blocks an SM) below BN = 128. With
// tma_x, one thread loads each stage's span by TMA (32-byte rows of tx) and
// the stage's mbarrier counts the bytes in; with tma_w, it loads the
// weights the same way ([BN or 64][16][1] boxes of tw). Without (C or O not
// a multiple of 8, or an unaligned tensor), every thread copies elements
// into the same layout.
template <int BN>
__global__ void __launch_bounds__(NT_BF16, BN >= 128 ? 1 : 2)
conv3x3_flat_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                         FlatShape s, int relu, float* ws, int* counters, int tma_x,
                         int tma_w) {
  constexpr int BM = BM_BF16, NT = NT_BF16;
  constexpr int NACC = BN / 2;
  constexpr int TG = 3;  // taps per wgmma group: one dy
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[STAGES];
  // Swizzled layouts repeat every 1024 bytes: align the stages to that.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int span_elems = bf16_span_elems(s.span);
  const int stage_bytes = bf16_stage_bytes(s.span, BN);

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int q0 = (blockIdx.x - img * s.tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + (size_t)img * s.rows * s.C;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // Blocks start their chunks at different places, so that they do not all
  // read the same weights at once. The place is the tile's within its image,
  // not the block's index: an output's order of sums is then the same at
  // every batch and in every lane.
  const int rot = (blockIdx.x - img * s.tiles) % s.chunks;
  const int chunk0 = blockIdx.z * s.chunks;

  auto load = [&](int kc, int stage) {
    const int c0 = (chunk0 + (kc + rot) % s.chunks) * BK_BF16;
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + stage * stage_bytes);
    __nv_bfloat16* Bs = As + span_elems;
    if ((tma_x || tma_w) && tid == 0) {
      uint64_t* bar = bars + stage;
      mbar_expect(bar, (tma_x ? span_elems * 2 : 0) + (tma_w ? 9 * BK_BF16 * BN * 2 : 0));
      if (tma_x)
        for (int r = 0; r < span_elems / BK_BF16; r += BOX_ROWS)
          tma_2d(As + r * BK_BF16, &tx, c0, img * s.rows + q0 + r, bar);
      if (tma_w)
        for (int t = 0; t < 9; ++t)
          for (int h = 0; h < (BN + 63) / 64; ++h)
            tma_3d(Bs + t * BK_BF16 * BN + h * 1024, &tw, n0 + h * 64, c0, t, bar);
    }
    if (!tma_x)
      for (int i = tid; i < s.span * BK_BF16; i += NT) {
        const int r = i / BK_BF16, k = i % BK_BF16;
        const int g = q0 + r, c = c0 + k;
        As[a_swz(r, k)] = (g < s.rows && c < s.C) ? xb[(size_t)g * s.C + c] : zero;
      }
    if (!tma_w)
      for (int i = tid; i < 9 * BK_BF16 * BN; i += NT) {
        const int n = i % BN, k = (i / BN) % BK_BF16, t = i / (BN * BK_BF16);
        const int c = c0 + k, o = n0 + n;
        Bs[b_swz<BN>(t, k, n)] =
            (c < s.C && o < s.O) ? w[((size_t)t * s.C + c) * s.O + o] : zero;
      }
  };

  const int warp = tid >> 5, lane = tid & 31;
  // ldmatrix row addresses: lanes 0-15 give rows 0-15 of the warp's first
  // eight channels, lanes 16-31 the same rows of the next eight.
  const int arow = warp * 16 + (lane & 15), ahalf = lane >> 4;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if ((tma_x || tma_w) && tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < s.chunks) load(st, st);
  for (int kc = 0; kc < s.chunks; ++kc) {
    if (tma_x || tma_w) mbar_wait(bars + kc % STAGES, (kc / STAGES) & 1);
    // The tensor cores read B through the async proxy: order plain stores
    // before them, then wait for every thread (which also frees the stage
    // read in the last iteration).
    if (!tma_w) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kc + STAGES - 1 < s.chunks) load(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
    const __nv_bfloat16* As =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kc % STAGES) * stage_bytes);
    const __nv_bfloat16* Bs = As + span_elems;
    // The taps in groups of TG: load the group's A fragments, issue its
    // wgmmas, wait for them (nine taps' A would take 36 registers).
#pragma unroll
    for (int t0 = 0; t0 < 9; t0 += TG) {
      uint32_t a[TG][4];
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        const int row = arow + ((t0 + t) / 3) * s.Wp + (t0 + t) % 3;
        conv3x3::ldmatrix_x4(a[t], As + row * BK_BF16 + (((ahalf ^ (row >> 2)) & 1) << 3));
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int t = 0; t < TG; ++t)
        wgmma_rs<BN>(acc, a[t], b_desc<BN>(Bs + (t0 + t) * BK_BF16 * BN));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      // Keep the A registers and the accumulators in place until the wait.
#pragma unroll
      for (int t = 0; t < TG; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(a[t][e]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(acc[i]);
    }
  }
  if (gridDim.z > 1 && !reduce_split<NT, NACC>(acc, ws, counters, gridDim.z)) return;

  // Accumulator of n8 tile i: e = 0,1 -> row g, channels 8i + 2*t4 + {0,1};
  // e = 2,3 -> row g + 8.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + warp * 16 + g + half * 8;  // warp counts across the warpgroups
    if (q >= s.M) continue;
    const int y = q / s.Wp, xx = q - y * s.Wp;
    if (xx >= s.W) continue;
    __nv_bfloat16* orow = out + (((size_t)img * s.H + y) * s.W + xx) * s.O;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + i * 8 + t4 * 2;
      const float b0 = n < s.O ? bias[n] : 0.f, b1 = n + 1 < s.O ? bias[n + 1] : 0.f;
      conv3x3::store_bf16_pair(orow, n, s.O,
                               conv3x3::bias_relu(acc[i * 4 + half * 2 + 0], b0, relu),
                               conv3x3::bias_relu(acc[i * 4 + half * 2 + 1], b1, relu));
    }
  }
}

FlatShape make_shape(int Hp, int Wp, int C, int O, int bm, int bk, int split) {
  FlatShape s;
  s.Wp = Wp;
  s.C = C;
  s.O = O;
  s.H = Hp - 2;
  s.W = Wp - 2;
  s.M = s.H * Wp;
  s.rows = Hp * Wp;
  s.span = bm + 2 * Wp + 2;
  s.tiles = (s.M + bm - 1) / bm;
  s.chunks = (C + bk - 1) / bk / split;
  return s;
}

struct Launch {
  const void *x, *w, *bias;
  void* out;
  int B, Hp, Wp, C, O, relu, split;
  float* ws;
  int* counters;
  cudaStream_t stream;
};

// A split must divide the channel chunks and, above 1, have its workspace.
bool split_ok(const Launch& l, int bk) {
  const int chunks = (l.C + bk - 1) / bk;
  return l.split >= 1 && chunks % l.split == 0 &&
         (l.split == 1 || (l.ws != nullptr && l.counters != nullptr));
}

template <int BM, int BN, int TN>
int launch_f32(const Launch& l) {
  static hopper::Granted granted;
  constexpr int NT = BM * BN / (8 * TN);
  if (!split_ok(l, BK_F32)) return static_cast<int>(cudaErrorInvalidValue);
  const FlatShape s = make_shape(l.Hp, l.Wp, l.C, l.O, BM, BK_F32, l.split);
  const size_t smem = sizeof(float) * STAGES *
                      (size_t)(BN == TN ? f32_stage_floats<true>(s.span, BN)
                                        : f32_stage_floats<false>(s.span, BN));
  cudaError_t err = hopper::allow_smem(conv3x3_flat_f32_kernel<BM, BN, TN>, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(l.B * s.tiles, (l.O + BN - 1) / BN, l.split);
  conv3x3_flat_f32_kernel<BM, BN, TN><<<grid, NT, smem, l.stream>>>(
      static_cast<const float*>(l.x), static_cast<const float*>(l.w),
      static_cast<const float*>(l.bias), static_cast<float*>(l.out), s, l.relu, l.ws,
      l.counters);
  return static_cast<int>(cudaGetLastError());
}

// The TMA maps of x (2-D: [C, B*Hp*Wp], 16 x 256 boxes, 32-byte swizzle)
// and w (3-D: [O, C, 9], min(BN, 64) x 16 x 1 boxes, 128-byte swizzle for
// BN >= 64). Out-of-bounds elements arrive as zeros.
template <int BN>
cudaError_t encode_maps(const Launch& l, bool tma_x, bool tma_w, CUtensorMap* tx,
                        CUtensorMap* tw) {
  if (!tma_x && !tma_w) return cudaSuccess;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t xdim[2] = {(cuuint64_t)l.C, (cuuint64_t)l.B * l.Hp * l.Wp};
  const cuuint64_t xstride[1] = {(cuuint64_t)l.C * 2};
  const cuuint32_t xbox[2] = {BK_BF16, BOX_ROWS}, ones[3] = {1, 1, 1};
  const cuuint64_t wdim[3] = {(cuuint64_t)l.O, (cuuint64_t)l.C, 9};
  const cuuint64_t wstride[2] = {(cuuint64_t)l.O * 2, (cuuint64_t)l.C * l.O * 2};
  const cuuint32_t wbox[3] = {BN < 64 ? BN : 64, BK_BF16, 1};
  if ((tma_x && encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(l.x), xdim,
                       xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) ||
      (tma_w && encode(tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(l.w), wdim,
                       wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       BN < 64 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int BN>
int launch_bf16(const Launch& l) {
  static hopper::Granted granted;
  if (!split_ok(l, BK_BF16)) return static_cast<int>(cudaErrorInvalidValue);
  const FlatShape s = make_shape(l.Hp, l.Wp, l.C, l.O, BM_BF16, BK_BF16, l.split);
  const size_t smem = (size_t)STAGES * bf16_stage_bytes(s.span, BN) + 1024;  // + alignment
  cudaError_t err = hopper::allow_smem(conv3x3_flat_bf16_kernel<BN>, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tx = {}, tw = {};
  // TMA needs 16-byte aligned bases and rows.
  const bool tma_x = l.C % 8 == 0 && (reinterpret_cast<uintptr_t>(l.x) & 15) == 0;
  const bool tma_w = l.O % 8 == 0 && (reinterpret_cast<uintptr_t>(l.w) & 15) == 0;
  if ((err = encode_maps<BN>(l, tma_x, tma_w, &tx, &tw)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid(l.B * s.tiles, (l.O + BN - 1) / BN, l.split);
  conv3x3_flat_bf16_kernel<BN><<<grid, NT_BF16, smem, l.stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(l.x), static_cast<const __nv_bfloat16*>(l.w),
      static_cast<const float*>(l.bias), static_cast<__nv_bfloat16*>(l.out), s, l.relu, l.ws,
      l.counters, tma_x, tma_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_conv3x3_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] and w [3, 3, C, O] f32, bias [O] f32, out [B, Hp-2, Wp-2, O]
// f32, on the tile bm x bn with the channel chunks split over `split` blocks
// (the wrapper's plan). With split > 1, ws holds split * bm * bn floats per
// tile and counters one zeroed int per tile. Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a tile the library does not have).
int stx_conv3x3_flat_f32(const void* x, const void* w, const void* bias, void* out, int B,
                         int Hp, int Wp, int C, int O, int relu, int bm, int bn, int split,
                         void* ws, void* counters, void* stream) {
  const Launch l{x, w, bias, out, B, Hp, Wp, C, O, relu, split, static_cast<float*>(ws),
                 static_cast<int*>(counters), static_cast<cudaStream_t>(stream)};
  if (bm == 128 && bn == 128) return launch_f32<128, 128, 8>(l);
  if (bm == 256 && bn == 64) return launch_f32<256, 64, 8>(l);
  if (bm == 128 && bn == 64) return launch_f32<128, 64, 8>(l);
  if (bm == 512 && bn == 4) return launch_f32<512, 4, 4>(l);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As stx_conv3x3_flat_f32 with x, w and out in bf16 (bias stays f32).
int stx_conv3x3_flat_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                          int Hp, int Wp, int C, int O, int relu, int bm, int bn, int split,
                          void* ws, void* counters, void* stream) {
  const Launch l{x, w, bias, out, B, Hp, Wp, C, O, relu, split, static_cast<float*>(ws),
                 static_cast<int*>(counters), static_cast<cudaStream_t>(stream)};
  if (bm == 128 && bn == 128) return launch_bf16<128>(l);
  if (bm == 128 && bn == 64) return launch_bf16<64>(l);
  if (bm == 128 && bn == 8) return launch_bf16<8>(l);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
