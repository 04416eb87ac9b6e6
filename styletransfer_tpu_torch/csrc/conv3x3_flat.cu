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
// What bounds it on an H100: the Gatys tower's convs (up to 256 px, C and O
// from 64 to 256) do 2.4 to 4.8 GFLOP on 8 to 34 MB in f32, so they are bound
// by operations: f32 runs on the CUDA cores (67 TFLOP/s; TF32 would drift
// from the f32 reference), bf16 on the tensor cores. The conv of C = 64 to
// O = 3 (conv1_1's input gradient) moves more bytes than it computes.
//
// Design: the flattened padded image is a [Hp*Wp, C] matrix, and a tap
// (dy, dx) of output position q of the Wp-wide output grid reads input row
// q + dy*Wp + dx. A block owns BM = 128 consecutive positions q0.. of one
// image and BN output channels. Per chunk of channels it stages the one
// contiguous span of BM + 2*Wp + 2 input rows those positions touch in shared
// memory, with the weights of all nine taps, and reads each tap as a window
// of the span shifted by dy*Wp + dx: an input element is loaded from memory
// once per block and used by all nine taps. The kernel masks rows past the
// end of the image and channels past C itself (any C >= 1 and O >= 1); the
// two garbage columns of each row are computed and not stored.
//   f32:  FMA on an 8 x TN register tile per thread (256 threads, 8 channels
//         per chunk). A thread's 8 positions are consecutive, so the three
//         dx taps of one dy reuse 10 values read from shared memory.
//   bf16: mma.sync m16n8k16 with f32 accumulation (8 warps, each 32 positions
//         by BN / 2 channels; 16 channels per chunk, one k step per tap),
//         fragments read with ldmatrix at the shifted rows.
// BN is 128 for O > 64 and shrinks with O (down to 16 in f32, 32 in bf16), so
// the O = 3 conv wastes little of its tile. Not yet used: cp.async/TMA
// pipelines that overlap the next chunk's loads with this one's math, wgmma.

#include "conv3x3_common.cuh"

namespace {

using conv3x3::f32_col;

constexpr int BM = 128;  // positions of the Wp-wide output grid per block
constexpr int NT = 256;  // threads per block

struct FlatShape {
  int Wp, C, O, H, W;
  int M;      // H * Wp: positions of the output grid
  int rows;   // Hp * Wp: rows of the flattened input
  int span;   // BM + 2 * Wp + 2: input rows that one block reads
  int tiles;  // blocks per image along the positions
};

// ---------------------------------------------------------------- f32 path
constexpr int BK_F32 = 8;
static_assert(BK_F32 == 8, "the f32 span loader assumes two float4 per row");

template <int TN>
__global__ void __launch_bounds__(NT)
conv3x3_flat_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out,
                        FlatShape s, int relu) {
  constexpr int BN = 16 * TN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // As[k][row of the span]
  float* Bs = As + BK_F32 * s.span;                // Bs[tap][k][n]

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int q0 = (blockIdx.x - img * s.tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + (size_t)img * s.rows * s.C;
  const int ty = tid >> 4, tx = tid & 15;
  const bool vec = (s.C & 3) == 0;

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < s.C; c0 += BK_F32) {
    if (vec) {
      for (int i = tid; i < s.span * (BK_F32 / 4); i += NT) {
        const int r = i >> 1, k = (i & 1) * 4;
        const int g = q0 + r, c = c0 + k;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < s.rows && c < s.C) v = *reinterpret_cast<const float4*>(xb + (size_t)g * s.C + c);
        As[(k + 0) * s.span + r] = v.x;
        As[(k + 1) * s.span + r] = v.y;
        As[(k + 2) * s.span + r] = v.z;
        As[(k + 3) * s.span + r] = v.w;
      }
    } else {
      for (int i = tid; i < s.span * BK_F32; i += NT) {
        const int r = i / BK_F32, k = i % BK_F32;
        const int g = q0 + r, c = c0 + k;
        As[k * s.span + r] = (g < s.rows && c < s.C) ? xb[(size_t)g * s.C + c] : 0.f;
      }
    }
    for (int i = tid; i < 9 * BK_F32 * BN; i += NT) {
      const int n = i % BN, k = (i / BN) % BK_F32, t = i / (BN * BK_F32);
      const int c = c0 + k, o = n0 + n;
      Bs[i] = (c < s.C && o < s.O) ? w[((size_t)t * s.C + c) * s.O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 2
      for (int k = 0; k < BK_F32; ++k) {
        const float* ar = As + k * s.span + dy * s.Wp + ty * 8;
        float a[10];
#pragma unroll
        for (int r = 0; r < 10; ++r) a[r] = ar[r];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* br = Bs + ((dy * 3 + dx) * BK_F32 + k) * BN;
          float b[TN];
          if constexpr (TN >= 4) {
#pragma unroll
            for (int gq = 0; gq < TN / 4; ++gq) {
              const float4 v = *reinterpret_cast<const float4*>(br + gq * 64 + tx * 4);
              b[gq * 4 + 0] = v.x;
              b[gq * 4 + 1] = v.y;
              b[gq * 4 + 2] = v.z;
              b[gq * 4 + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = br[f32_col<TN>(tx, j)];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i + dx], b[j], acc[i][j]);
        }
      }
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
    const int q = q0 + ty * 8 + i;
    if (q >= s.M) break;
    const int y = q / s.Wp, xx = q - y * s.Wp;
    if (xx >= s.W) continue;  // one of the two garbage columns of the row
    float* orow = out + (((size_t)img * s.H + y) * s.W + xx) * s.O;
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
constexpr int BK_BF16 = 16;  // one k step of mma.sync per tap and chunk
static_assert(BK_BF16 == 16, "the bf16 span loader assumes two 16-byte loads per row");
constexpr int A_LD = BK_BF16 + 8;  // span row pitch in bf16: 48 bytes, ldmatrix conflict-free

// NI: n8 tiles per warp. Warps: 4 along the positions (32 each) by 2 along
// the channels (NI * 8 each), so BN = 16 * NI.
template <int NI>
__global__ void __launch_bounds__(NT)
conv3x3_flat_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                         FlatShape s, int relu) {
  constexpr int BN = 16 * NI;
  constexpr int B_LD = BN + 8;  // weight row pitch in bf16, ldmatrix conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // As[row][k]
  __nv_bfloat16* Bs = As + (size_t)s.span * A_LD;                  // Bs[tap][k][n]

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int q0 = (blockIdx.x - img * s.tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + (size_t)img * s.rows * s.C;
  const bool vec_x = (s.C & 7) == 0, vec_w = (s.O & 7) == 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: lanes 0-15 give rows 0-15 of the first eight
  // columns, lanes 16-31 the same rows of the next eight.
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int c0 = 0; c0 < s.C; c0 += BK_BF16) {
    if (vec_x) {
      for (int i = tid; i < s.span * (BK_BF16 / 8); i += NT) {
        const int r = i >> 1, k = (i & 1) * 8;
        const int gr = q0 + r, c = c0 + k;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < s.rows && c < s.C) v = *reinterpret_cast<const uint4*>(xb + (size_t)gr * s.C + c);
        *reinterpret_cast<uint4*>(As + r * A_LD + k) = v;
      }
    } else {
      for (int i = tid; i < s.span * BK_BF16; i += NT) {
        const int r = i / BK_BF16, k = i % BK_BF16;
        const int gr = q0 + r, c = c0 + k;
        As[r * A_LD + k] = (gr < s.rows && c < s.C) ? xb[(size_t)gr * s.C + c] : zero;
      }
    }
    if (vec_w) {
      for (int i = tid; i < 9 * BK_BF16 * (BN / 8); i += NT) {
        const int n = (i % (BN / 8)) * 8, k = (i / (BN / 8)) % BK_BF16;
        const int t = i / ((BN / 8) * BK_BF16);
        const int c = c0 + k, o = n0 + n;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < s.C && o < s.O)
          v = *reinterpret_cast<const uint4*>(w + ((size_t)t * s.C + c) * s.O + o);
        *reinterpret_cast<uint4*>(Bs + (t * BK_BF16 + k) * B_LD + n) = v;
      }
    } else {
      for (int i = tid; i < 9 * BK_BF16 * BN; i += NT) {
        const int n = i % BN, k = (i / BN) % BK_BF16, t = i / (BN * BK_BF16);
        const int c = c0 + k, o = n0 + n;
        Bs[(t * BK_BF16 + k) * B_LD + n] =
            (c < s.C && o < s.O) ? w[((size_t)t * s.C + c) * s.O + o] : zero;
      }
    }
    __syncthreads();
#pragma unroll 3
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * s.Wp + (t % 3);
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        conv3x3::ldmatrix_x4(a[mi], As + (size_t)(wm * 32 + mi * 16 + lrow + off) * A_LD + lcol);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];  // b[0..1]: n tile 2*np, b[2..3]: n tile 2*np + 1
        conv3x3::ldmatrix_x4_trans(
            b, Bs + (t * BK_BF16 + lrow) * B_LD + wn * (NI * 8) + np * 16 + lcol);
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
      const int q = q0 + wm * 32 + mi * 16 + g + half * 8;
      if (q >= s.M) continue;
      const int y = q / s.Wp, xx = q - y * s.Wp;
      if (xx >= s.W) continue;
      __nv_bfloat16* orow = out + (((size_t)img * s.H + y) * s.W + xx) * s.O;
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

FlatShape make_shape(int Hp, int Wp, int C, int O) {
  FlatShape s;
  s.Wp = Wp;
  s.C = C;
  s.O = O;
  s.H = Hp - 2;
  s.W = Wp - 2;
  s.M = s.H * Wp;
  s.rows = Hp * Wp;
  s.span = BM + 2 * Wp + 2;
  s.tiles = (s.M + BM - 1) / BM;
  return s;
}

template <int TN>
int launch_f32(const void* x, const void* w, const void* bias, void* out, int B,
               const FlatShape& s, int relu, cudaStream_t st) {
  static size_t granted = 0;
  constexpr int BN = 16 * TN;
  const size_t smem = sizeof(float) * ((size_t)BK_F32 * s.span + 9 * BK_F32 * BN);
  cudaError_t err = conv3x3::allow_smem(conv3x3_flat_f32_kernel<TN>, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * s.tiles, (s.O + BN - 1) / BN);
  conv3x3_flat_f32_kernel<TN><<<grid, NT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), s, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int NI>
int launch_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                const FlatShape& s, int relu, cudaStream_t st) {
  static size_t granted = 0;
  constexpr int BN = 16 * NI;
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)s.span * A_LD + 9 * BK_BF16 * (BN + 8));
  cudaError_t err = conv3x3::allow_smem(conv3x3_flat_bf16_kernel<NI>, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * s.tiles, (s.O + BN - 1) / BN);
  conv3x3_flat_bf16_kernel<NI><<<grid, NT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), s, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_conv3x3_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] and w [3, 3, C, O] f32, bias [O] f32, out [B, Hp-2, Wp-2, O]
// f32. Returns a cudaError_t (0 on success).
int stx_conv3x3_flat_f32(const void* x, const void* w, const void* bias, void* out, int B,
                         int Hp, int Wp, int C, int O, int relu, void* stream) {
  const FlatShape s = make_shape(Hp, Wp, C, O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O > 64) return launch_f32<8>(x, w, bias, out, B, s, relu, st);
  if (O > 32) return launch_f32<4>(x, w, bias, out, B, s, relu, st);
  if (O > 16) return launch_f32<2>(x, w, bias, out, B, s, relu, st);
  return launch_f32<1>(x, w, bias, out, B, s, relu, st);
}

// As stx_conv3x3_flat_f32 with x, w and out in bf16 (bias stays f32).
int stx_conv3x3_flat_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                          int Hp, int Wp, int C, int O, int relu, void* stream) {
  const FlatShape s = make_shape(Hp, Wp, C, O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O > 64) return launch_bf16<8>(x, w, bias, out, B, s, relu, st);
  if (O > 32) return launch_bf16<4>(x, w, bias, out, B, s, relu, st);
  return launch_bf16<2>(x, w, bias, out, B, s, relu, st);
}

}  // extern "C"
