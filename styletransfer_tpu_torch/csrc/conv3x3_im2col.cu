// 3x3 VALID convolution + bias (+ReLU) of a pre-padded NHWC image, no
// statistics: the im2col form, one product of depth K = 9*C.
//
// Replaces the TPU kernel styletransfer_tpu/ops/pallas/conv3x3.py
// (conv3x3_im2col -> _im2col_kernel): the same function as conv3x3_flat.cu,
// computed as [M, 9C] x [9C, O] with the im2col operand staged on chip. The
// port runs the 3x3 convs with few input channels (C < 32) on it: in the
// Gatys tower that is conv1_1 (C = 3), where nine per-tap products of depth 3
// would leave the multiply units idle and one product of depth 27 does not.
//
// What bounds it on an H100: conv1_1 at 256 px is 0.23 GFLOP on 1 MB in and
// 17 MB out (f32), so it moves more bytes than it computes: the output
// write bounds it (about 5 us at 3.35 TB/s).
//
// Design: a block owns BM = 128 output pixels of one image and BN output
// channels. It walks K = 9*C in slices; for each it gathers the [BM, slice]
// block of the im2col operand from the shifted input rows (column k = tap*C + c
// of pixel (y, x) is xpad[y + dy, x + dx, c]) into shared memory, with the
// matching [slice, BN] rows of w reshaped to [9C, O], and multiplies. For
// C = 3 the whole operand (K = 27) is one slice. Columns past K and pixels
// past the image are zero, so any C >= 1 and O >= 1 work.
//   f32:  FMA on an 8 x TN register tile per thread (256 threads, slices of 16).
//   bf16: mma.sync m16n8k16 with f32 accumulation (8 warps, each 32 pixels by
//         BN / 2 channels; slices of 32), fragments read with ldmatrix.
// The output is stored from the accumulators after the bias and ReLU, in
// 16-byte groups (f32) or channel pairs (bf16) where O allows it.

#include "conv3x3_common.cuh"

namespace {

using conv3x3::f32_col;

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
// f32. Returns a cudaError_t (0 on success).
int stx_conv3x3_im2col_f32(const void* x, const void* w, const void* bias, void* out, int B,
                           int Hp, int Wp, int C, int O, int relu, void* stream) {
  const Im2colShape s = make_shape(Hp, Wp, C, O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O > 64) return launch<float>(conv3x3_im2col_f32_kernel<8>, 128, x, w, bias, out, B, s, relu, st);
  if (O > 32) return launch<float>(conv3x3_im2col_f32_kernel<4>, 64, x, w, bias, out, B, s, relu, st);
  if (O > 16) return launch<float>(conv3x3_im2col_f32_kernel<2>, 32, x, w, bias, out, B, s, relu, st);
  return launch<float>(conv3x3_im2col_f32_kernel<1>, 16, x, w, bias, out, B, s, relu, st);
}

// As stx_conv3x3_im2col_f32 with x, w and out in bf16 (bias stays f32).
int stx_conv3x3_im2col_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                            int Hp, int Wp, int C, int O, int relu, void* stream) {
  const Im2colShape s = make_shape(Hp, Wp, C, O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (O > 64) return launch<bf16>(conv3x3_im2col_bf16_kernel<8>, 128, x, w, bias, out, B, s, relu, st);
  if (O > 32) return launch<bf16>(conv3x3_im2col_bf16_kernel<4>, 64, x, w, bias, out, B, s, relu, st);
  return launch<bf16>(conv3x3_im2col_bf16_kernel<2>, 32, x, w, bias, out, B, s, relu, st);
}

}  // extern "C"
