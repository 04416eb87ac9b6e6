// The transform net's last conv, conv_out (9x9, 32 -> 3), and its input
// gradient (a 9x9 conv 3 -> 32): one direct 9x9 VALID convolution (+ bias)
// of a pre-padded NHWC image in f32.
//
// Not the port of a TPU kernel: the JAX package leaves conv_out to XLA
// (styletransfer_tpu/models/transformer.py: _apply_padearly runs it as a 3x3
// 512 -> 48 conv of the 4x4 space-to-depth input, _apply_stacked as a 9x9
// conv of the padded input) and its gradients to XLA's autodiff. The port ran
// both on cuDNN: the phase form multiplies 13,824 products a pixel where the
// 9x9 conv has 7,776 (the rest are zero taps) and brings a space-to-depth
// copy, layout transforms and a depth_to_space; cuDNN's input gradient of the
// 9x9 conv (dgrad_engine) ran under 1% of its bound.
//   out[b, y, x, o] = bias[o] + sum_{ky, kx, c} xp[b, y + ky, x + kx, c] * w[ky, kx, c, o]
// xp [B, H + 8, W + 8, C], w [9, 9, C, O] (HWIO), bias [O] or none, out
// [B, H, W, O]; f32 in, f32 products and sums (FMA, no TF32), f32 out, NHWC.
// Two instances of one template:
//   (C, O) = (32, 3), the forward: serving (up2_in's IN-pad writes xp) and
//     training (the stacked forward pads the input itself);
//   (3, 32), the input gradient: the gradient of xp is the VALID 9x9 conv of
//     dy zero-padded by 8 with the kernel turned 180 degrees and its in and
//     out channels swapped, dxp[b, Y, X, c] = sum_{ky, kx, o}
//     dyp[b, Y + ky, X + kx, o] * w[8 - ky, 8 - kx, c, o]
//     (ops/cuda/conv9x9.py::Conv9x9Function).
//
// What bounds it on an H100: operations, 81 * C * O = 7,776 multiply-adds
// an output pixel in both instances. At batch 64 and 256 px the forward is
// 65.2 GFLOP against 0.57 GB read: 0.97 ms at the 67 TFLOP/s of the CUDA
// cores, 0.17 ms of bytes. At batch 4 the forward is 4.08 GFLOP (61 us); the
// input gradient, whose output is the padded 264 x 264 grid, 4.34 GFLOP
// (65 us) against 36 MB written (11 us).
//
// Design: FMA on the CUDA cores, from a register tile in which a thread uses
// each value it reads from shared memory many times. No zero tap is
// multiplied, and nothing is copied or re-laid out around the kernel.
//   (32, 3), output-light: a thread owns RUN consecutive pixels of one row
//   and all 3 channels (3 * RUN accumulators). Per (c, ky) it reads the
//   RUN + 8 window values of its row once, as float4s, and the 27 weights of
//   (kx, o) as 7 float4 broadcasts, and does 27 * RUN FMAs: at RUN = 16, 432
//   for 13 shared-memory loads. A block (32 rows by 8 runs of 16 pixels, 256
//   threads, one an SM; or 32 rows by 4 runs of 8, 128 threads, three an SM)
//   walks C in chunks of CK = 4 channels through a two-stage cp.async ring:
//   the next chunk's window (the tile and 8 more rows and columns, transposed
//   into channel planes) and weights (re-laid [c][ky][kx * O + o]) are in
//   flight while a chunk computes.
//   (3, 32), input-light: a thread owns 8 pixels of one row and 8 of the 32
//   channels (64 accumulators). Per (c, ky) it reads its 16 window values
//   once and per kx 2 float4 of weights, each used 8 times. The whole window
//   (three channel planes) and all 7,776 weights are staged once a block
//   (256 threads: 4 channel groups by 16 rows by 4 runs), as in
//   conv3x3_im2col.cu's band route for C = 3.
// The tile follows the shape alone (ops/cuda/conv9x9.py::plan): the forward
// takes RUN = 16 (32 x 128 pixels a block) where that fills at least 4 waves
// of the card, else RUN = 8 (32 x 32), four times the blocks: batch 4 at 256
// px is 256 blocks, about two an SM, where RUN = 16 would leave 64 blocks for
// 132 SMs. At batch 64 and 256 px on an H100 the 32 x 128 tile runs in
// 1.74-1.78 ms (55% of the bound), where a 32 x 64 tile of 128 threads, two
// blocks an SM, ran in 2.02-2.03 ms.
// Banks: the lanes of a warp read one column of 8 (or, for (3, 32), 2)
// window rows in each quarter-warp, and the row pitch is 4 mod 8 floats, so
// their 16-byte reads fall in distinct banks; a channel plane is 8 mod 32
// floats, so a warp's transposing copies (8 pixels by 4 channels) do too.
//
// Order: every output sums its 81 * C products in one fixed order (chunks
// ascending, then c, ky, kx) into one accumulator from 0, then adds the bias.
// There is no split over C and no atomic, and the order does not depend on
// the tile: a call repeats bit for bit, and an image's output does not depend
// on the batch. The kernel launches on the caller's stream, allocates nothing
// and never synchronises, so a CUDA graph can capture it.

#include "hopper.cuh"

namespace {

using conv3x3::smem_addr;

constexpr int KS = 9;         // kernel size
constexpr int HALO = KS - 1;  // window rows and columns past the tile

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An instance: C input and O output channels; a thread owns RUN pixels of one
// row and OCT of the O channels; the lanes run over the O / OCT channel groups
// first, then over TR rows, then over TCR runs of a row; CK input channels a
// chunk; MINB blocks an SM (registers).
template <int C_, int O_, int RUN_, int OCT_, int TR_, int TCR_, int CK_, int MINB_>
struct Tile {
  static constexpr int C = C_, O = O_, RUN = RUN_, OCT = OCT_, TR = TR_, TCR = TCR_, CK = CK_;
  static constexpr int MINB = MINB_;
  static constexpr int OG = O / OCT;
  static constexpr int NT = OG * TR * TCR;
  static constexpr int TH = TR, TW = TCR * RUN;
  static constexpr int WIN_H = TH + HALO, WIN_W = TW + HALO;
  // Row pitch 4 mod 8 floats, a channel plane 8 mod 32 floats (see above).
  static constexpr int PITCH = (WIN_W + 3) / 4 % 2 ? (WIN_W + 3) / 4 * 4 : (WIN_W + 3) / 4 * 4 + 4;
  static constexpr int PLANE = (WIN_H * PITCH + 23) / 32 * 32 + 8;
  // One (c, ky) row of weights, (kx, o), padded to whole float4s.
  static constexpr int KROW = (KS * O + 3) / 4 * 4;
  static constexpr int A_STAGE = CK * PLANE;
  static constexpr int B_STAGE = CK * KS * KROW;
  static constexpr int CHUNKS = C / CK;
  static constexpr int STAGES = CHUNKS > 1 ? 2 : 1;
  static constexpr size_t SMEM = sizeof(float) * STAGES * (A_STAGE + B_STAGE);
  static_assert(C % CK == 0 && O % OCT == 0 && (OCT == O || OCT % 4 == 0), "channels");
  static_assert(RUN % 4 == 0 && RUN * OCT % 4 == 0, "float4 runs");
};

using Fwd16 = Tile<32, 3, 16, 3, 32, 8, 4, 1>;
using Fwd8 = Tile<32, 3, 8, 3, 32, 4, 4, 3>;
using Dgrad = Tile<3, 32, 8, 8, 16, 4, 3, 2>;

struct Shape {
  int Hp, Wp, H, W, tiles_x;
};

// Shared memory, per stage: As[c][window row][PITCH] (window values past the
// input are zeros), then Bs[c][ky][KROW].
//
// grid (tiles of the output, B).
template <class T>
__global__ void __launch_bounds__(T::NT, T::MINB)
conv9x9_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, Shape s) {
  constexpr int C = T::C, O = T::O, RUN = T::RUN, OCT = T::OCT, CK = T::CK, NT = T::NT;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + T::STAGES * T::A_STAGE;

  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int ty0 = blockIdx.x / s.tiles_x, tx0 = blockIdx.x - ty0 * s.tiles_x;
  const int Y0 = ty0 * T::TH, X0 = tx0 * T::TW;
  const float* xb = x + (size_t)img * s.Hp * s.Wp * C;

  // This thread's outputs: channels og * OCT + {0 .. OCT - 1} of tile row tr,
  // pixels x0 .. x0 + RUN - 1 of the tile.
  const int og = tid % T::OG;
  const int tr = tid / T::OG % T::TR;
  const int x0 = tid / (T::OG * T::TR) * RUN;

  auto load_stage = [&](int stage, int c0) {
    float* as = As + stage * T::A_STAGE;
    float* bs = Bs + stage * T::B_STAGE;
    // The window, one float a copy, channel fastest across threads
    // (coalesced in NHWC) and transposed into channel planes.
    constexpr int AE = CK * T::WIN_H * T::WIN_W;
    for (int e = tid; e < AE; e += NT) {
      const int c = e % CK, p = e / CK;
      const int wr = p / T::WIN_W, wc = p - wr * T::WIN_W;
      const int gy = Y0 + wr, gx = X0 + wc;
      const bool ok = gy < s.Hp && gx < s.Wp;
      cp_async4(as + c * T::PLANE + wr * T::PITCH + wc,
                ok ? xb + ((size_t)gy * s.Wp + gx) * C + c0 + c : x, ok ? 4 : 0);
    }
    // The chunk's weights w[ky][kx][c0 + c][o] -> Bs[c][ky][kx * O + o]: 16
    // bytes a copy where O allows it.
    constexpr int VEC = O % 4 == 0 ? 4 : 1;
    constexpr int OV = O / VEC, BE = CK * KS * KS * OV;
    for (int f = tid; f < BE; f += NT) {
      const int o = f % OV * VEC, t = f / OV;
      const int kx = t % KS, cky = t / KS;
      const int ky = cky % KS, c = cky / KS;
      const float* src = w + ((size_t)(ky * KS + kx) * C + c0 + c) * O + o;
      float* dst = bs + cky * T::KROW + kx * O + o;
      if constexpr (VEC == 4) {
        cp_async16(dst, src);
      } else {
        cp_async4(dst, src, 4);
      }
    }
  };

  float acc[RUN][OCT];
#pragma unroll
  for (int j = 0; j < RUN; ++j)
#pragma unroll
    for (int o = 0; o < OCT; ++o) acc[j][o] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < T::CHUNKS; ++k) {
    if (k + 1 < T::CHUNKS) {
      load_stage((k + 1) % T::STAGES, (k + 1) * CK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As + (k % T::STAGES) * T::A_STAGE + tr * T::PITCH + x0;
    const float* bs = Bs + (k % T::STAGES) * T::B_STAGE + og * OCT;
#pragma unroll 3
    for (int cky = 0; cky < CK * KS; ++cky) {
      const int c = cky / KS, ky = cky - c * KS;
      const float* ap = as + c * T::PLANE + ky * T::PITCH;
      float a[RUN + HALO];
#pragma unroll
      for (int q = 0; q < (RUN + HALO) / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ap + 4 * q);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      const float* wp = bs + cky * T::KROW;
      if constexpr (OCT == O) {
        // All O channels: the row's 9 * O weights as float4 broadcasts.
        float wv[T::KROW];
#pragma unroll
        for (int q = 0; q < T::KROW / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(wp + 4 * q);
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int kx = 0; kx < KS; ++kx)
#pragma unroll
          for (int o = 0; o < O; ++o)
#pragma unroll
            for (int j = 0; j < RUN; ++j)
              acc[j][o] = fmaf(a[j + kx], wv[kx * O + o], acc[j][o]);
      } else {
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          float wv[OCT];
#pragma unroll
          for (int q = 0; q < OCT / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(wp + kx * O + 4 * q);
            wv[4 * q] = v.x;
            wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z;
            wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < RUN; ++j)
#pragma unroll
            for (int o = 0; o < OCT; ++o) acc[j][o] = fmaf(a[j + kx], wv[o], acc[j][o]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // Epilogue: the bias, then pixels x .. x + RUN - 1 of row y, channels
  // og * OCT .. of [B, H, W, O].
  const int y = Y0 + tr, xs = X0 + x0;
  if (y >= s.H || xs >= s.W) return;
  float bv[OCT];
#pragma unroll
  for (int o = 0; o < OCT; ++o) bv[o] = bias ? bias[og * OCT + o] : 0.f;
  float* orow = out + (((size_t)img * s.H + y) * s.W + xs) * O + og * OCT;
  if constexpr (OCT == O) {
    // The run's RUN * O floats are contiguous: float4s where the run lies
    // whole in the row and starts on 16 bytes.
    float v[RUN * O];
#pragma unroll
    for (int j = 0; j < RUN; ++j)
#pragma unroll
      for (int o = 0; o < O; ++o) v[j * O + o] = acc[j][o] + bv[o];
    if (xs + RUN <= s.W && (reinterpret_cast<uintptr_t>(orow) & 15) == 0) {
#pragma unroll
      for (int q = 0; q < RUN * O / 4; ++q)
        reinterpret_cast<float4*>(orow)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
      const int n = (s.W - xs < RUN ? s.W - xs : RUN) * O;
#pragma unroll
      for (int i = 0; i < RUN * O; ++i)
        if (i < n) orow[i] = v[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (xs + j >= s.W) break;
#pragma unroll
      for (int q = 0; q < OCT / 4; ++q)
        reinterpret_cast<float4*>(orow + (size_t)j * O)[q] =
            make_float4(acc[j][4 * q] + bv[4 * q], acc[j][4 * q + 1] + bv[4 * q + 1],
                        acc[j][4 * q + 2] + bv[4 * q + 2], acc[j][4 * q + 3] + bv[4 * q + 3]);
    }
  }
}

template <class T>
int launch(const float* x, const float* w, const float* bias, float* out, int B, int Hp, int Wp,
           cudaStream_t stream) {
  static hopper::Granted granted;
  cudaError_t err = hopper::allow_smem(conv9x9_f32_kernel<T>, T::SMEM, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.Hp = Hp;
  s.Wp = Wp;
  s.H = Hp - HALO;
  s.W = Wp - HALO;
  s.tiles_x = (s.W + T::TW - 1) / T::TW;
  const dim3 grid(s.tiles_x * ((s.H + T::TH - 1) / T::TH), B);
  conv9x9_f32_kernel<T><<<grid, T::NT, T::SMEM, stream>>>(x, w, bias, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_conv9x9_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] f32, w [9, 9, C, O] f32 (HWIO), bias [O] f32 or NULL, out
// [B, Hp - 8, Wp - 8, O] f32; every pointer 16-byte aligned. (C, O) is (32, 3)
// with run 16 or 8 (the pixels a thread owns; ops/cuda/conv9x9.py::plan), or
// (3, 32) with run 8. Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for a shape the library does not take).
int stx_conv9x9_f32(const void* x, const void* w, const void* bias, void* out, int B, int Hp,
                    int Wp, int C, int O, int run, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out);
  if (B < 1 || B > 65535 || Hp < KS || Wp < KS || (ptrs & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 32 && O == 3 && run == 16) return launch<Fwd16>(xf, wf, bf, of, B, Hp, Wp, st);
  if (C == 32 && O == 3 && run == 8) return launch<Fwd8>(xf, wf, bf, of, B, Hp, Wp, st);
  if (C == 3 && O == 32 && run == 8) return launch<Dgrad>(xf, wf, bf, of, B, Hp, Wp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
