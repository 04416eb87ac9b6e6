// The transform net's decoder conv, `nearest-upsample x2 -> reflect-pad 1 ->
// conv3x3 + bias`, in 2x2 phase form on the small grid: four phases of 2x2
// taps each, the bias and the depth_to_space in one kernel.
//
// Not the port of a TPU kernel: the JAX package leaves these convs to XLA
// (styletransfer_tpu/models/transformer.py, _apply_padearly: one 3x3 VALID
// conv of the phase kernel, then depth_to_space). The port ran them the same
// way on cuDNN, which multiplies the five zero taps of each phase's 3x3
// kernel and picked an FFT algorithm for up2_conv at 12.5% of its bound.
//   out[b, 2y+py, 2x+px, o] = bias[o] + sum_{ty, tx, c}
//       xp[b, y+py+ty, x+px+tx, c] * w[py, px, ty, tx, c, o]
// with xp the small grid edge-padded by 1 ([B, h+2, w+2, C], what the
// instance norm before writes) and w the four phases' 2x2 combined kernels
// (ops/layers.py::upsample_phase_taps). f32 in, f32 products and sums (no
// TF32), f32 out [B, 2h, 2w, O], NHWC.
//
// What bounds it on an H100: operations. At batch 64 and 256 px each of the
// net's two calls (C, O) = (128, 64) on a 64x64 grid and (64, 32) on a
// 128x128 grid is 16*C*O multiply-adds per small-grid pixel, 6.87e10
// operations, against 0.28 GB (up2) or fewer moved: 1.03 ms at the 67 TFLOP/s
// of the CUDA cores, 0.24 ms of bytes.
//
// Design: FMA on the CUDA cores. A block (256 threads) owns a tile of TH x 32
// small-grid pixels of ONE image, all four phases and all O channels. Per
// chunk of CK input channels it stages the (TH + 2) x 34 window of the input
// (channel-major, so that a row of pixels is contiguous) and the chunk's
// 16 * CK * O weights in shared memory, through a two-stage cp.async ring:
// the next chunk's copies are in flight while a chunk computes. A thread
// owns 8 consecutive pixels of one tile row, all four phases and 4 output
// channels: 128 accumulators. Per (c, window row dy) it reads the 10 window
// values (x0 .. x0 + 9) that every phase and tap on that row needs once,
// and for each of the (py, ty) with py + ty = dy and each (px, tx) 4
// weights: 512 FMAs a channel for 25 shared-memory loads, so shared-memory
// bandwidth does not bound it (conv3x3.cu's 8x8 tile spends 4 loads on 64).
// The five zero taps of every phase are never multiplied. The epilogue adds
// the bias and writes rows 2y + py, columns 2x + px directly: the O / 4
// threads of a pixel store its O floats as float4 in one instruction, whole
// 128-byte lines. (A tile of 8 channels of one phase row stored half lines
// at O = 32 and ran up2 in 2.19 ms, against 1.66 for this one.) The stores
// are marked evict-first: every block reads all the weights (512 KB at
// up1) and its input window from L2, and the output, written once, would
// push them out (up1 1.87 ms with plain stores, 1.66 with these).
//
// Order: every output sums its 4 * C products in one fixed order (chunks
// ascending, then c, ty, tx) into one accumulator, then adds the bias. There
// is no split over C and no atomic, so a call repeats bit for bit. The kernel
// launches on the caller's stream, allocates nothing and never synchronises,
// so a CUDA graph can capture it.

#include "hopper.cuh"

namespace {

using conv3x3::smem_addr;

constexpr int NT = 256;          // threads per block
constexpr int CK = 8;            // input channels per chunk
constexpr int TW = 32;           // small-grid columns per tile
constexpr int RUN = 8;           // consecutive pixels per thread
constexpr int WIN_W = TW + 2;    // window columns
constexpr int PITCH = 36;        // window row pitch in floats (16-byte rows)
constexpr int STAGES = 2;

// The tile for O output channels: threads across 4-channel groups, the rest
// across pixel runs; TH rows of TW / RUN runs. A channel plane of the
// window is padded to 4 mod 32 floats, so that a warp's transposing copies
// (4 pixels x 8 channels) fall in 32 distinct banks.
template <int O>
struct Tile {
  static constexpr int NTH = O / 4;
  static constexpr int MTH = NT / NTH;
  static constexpr int TH = MTH / (TW / RUN);
  static constexpr int WIN_H = TH + 2;
  static constexpr int PLANE = (WIN_H * PITCH + 31) / 32 * 32 + 4;
  static constexpr int A_STAGE = CK * PLANE;
  static constexpr int B_STAGE = CK * 16 * O;
  static constexpr size_t SMEM = sizeof(float) * STAGES * (A_STAGE + B_STAGE);
  static_assert(NT % NTH == 0 && MTH % (TW / RUN) == 0, "tile");
};

struct Shape {
  int Hp, Wp, C, h, w, tiles_x, tiles;
};

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

// Shared memory, per stage: As[c][window row][PITCH] (window values past the
// input are zeros), then Bs[c][py][px][ty][tx][O].
//
// grid (tiles of the small grid, B).
template <int O>
__global__ void __launch_bounds__(NT, 1)
upconv_phase_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out, Shape s) {
  using T = Tile<O>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * T::A_STAGE;

  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int ty0 = blockIdx.x / s.tiles_x, tx0 = blockIdx.x - ty0 * s.tiles_x;
  const int Y0 = ty0 * T::TH, X0 = tx0 * TW;
  const float* xb = x + (size_t)img * s.Hp * s.Wp * s.C;

  // This thread's outputs: channels og * 4 + {0..3} of every phase, tile
  // row r, pixels x0 .. x0 + 7 of the tile.
  const int og = tid % T::NTH, m = tid / T::NTH;
  const int r = m / (TW / RUN), x0 = (m - r * (TW / RUN)) * RUN;

  auto load_stage = [&](int stage, int c0) {
    float* as = As + stage * T::A_STAGE;
    float* bs = Bs + stage * T::B_STAGE;
    // The window, one float a copy, channel-fastest across threads
    // (coalesced in NHWC) and transposed into channel planes.
    constexpr int AE = CK * T::WIN_H * WIN_W;
    for (int e = tid; e < AE; e += NT) {
      const int c = e % CK, p = e / CK;
      const int wr = p / WIN_W, wc = p - wr * WIN_W;
      const int gy = Y0 + wr, gx = X0 + wc;
      const bool ok = gy < s.Hp && gx < s.Wp;
      const float* src = ok ? xb + ((size_t)gy * s.Wp + gx) * s.C + c0 + c : x;
      cp_async4(as + c * T::PLANE + wr * PITCH + wc, src, ok ? 4 : 0);
    }
    // The weights: w[combo][c][o], combo = ((py * 2 + px) * 2 + ty) * 2 + tx,
    // 16 bytes a copy.
    constexpr int O4 = O / 4, BE = 16 * CK * O4;
    static_assert(BE % NT == 0, "weight copies");
#pragma unroll
    for (int i = 0; i < BE / NT; ++i) {
      const int f = tid + i * NT;
      const int o = (f % O4) * 4, t = f / O4;
      const int c = t % CK, combo = t / CK;
      cp_async16(bs + (c * 16 + combo) * O + o, w + ((size_t)combo * s.C + c0 + c) * O + o);
    }
  };

  float acc[4][RUN][4];  // [py * 2 + px][pixel][channel]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < RUN; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;

  const int chunks = s.C / CK;
  load_stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      load_stage((k + 1) % STAGES, (k + 1) * CK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As + (k % STAGES) * T::A_STAGE + r * PITCH + x0;
    const float* bs = Bs + (k % STAGES) * T::B_STAGE + og * 4;
#pragma unroll
    for (int c = 0; c < CK; ++c)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* ap = as + c * T::PLANE + dy * PITCH;
        const float4 a0 = *reinterpret_cast<const float4*>(ap);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
        const float2 a2 = *reinterpret_cast<const float2*>(ap + 8);
        const float a[RUN + 2] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
#pragma unroll
        for (int py = 0; py < 2; ++py) {
          const int ty = dy - py;
          if (ty < 0 || ty > 1) continue;
#pragma unroll
          for (int px = 0; px < 2; ++px)
#pragma unroll
            for (int tx = 0; tx < 2; ++tx) {
              const float4 bv = *reinterpret_cast<const float4*>(
                  bs + (c * 16 + ((py * 2 + px) * 2 + ty) * 2 + tx) * O);
              const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
              for (int i = 0; i < RUN; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc[py * 2 + px][i][j] = fmaf(a[i + px + tx], b[j], acc[py * 2 + px][i][j]);
            }
        }
      }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // Epilogue: the bias, then rows 2y + py, columns 2x + px of [B, 2h, 2w, O].
  const int y = Y0 + r;
  if (y >= s.h) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + og * 4);
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    float* orow = out + (((size_t)img * 2 * s.h + 2 * y + py) * 2 * s.w) * O + og * 4;
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const int xx = X0 + x0 + i;
      if (xx >= s.w) break;
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const float* v = acc[py * 2 + px][i];
        __stcs(reinterpret_cast<float4*>(orow + (size_t)(2 * xx + px) * O),
               make_float4(v[0] + bv.x, v[1] + bv.y, v[2] + bv.z, v[3] + bv.w));
      }
    }
  }
}

template <int O>
int run(const float* x, const float* w, const float* bias, float* out, int B, int Hp, int Wp,
        int C, cudaStream_t stream) {
  static hopper::Granted granted;
  using T = Tile<O>;
  cudaError_t err = hopper::allow_smem(upconv_phase_f32_kernel<O>, T::SMEM, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.Hp = Hp;
  s.Wp = Wp;
  s.C = C;
  s.h = Hp - 2;
  s.w = Wp - 2;
  s.tiles_x = (s.w + TW - 1) / TW;
  s.tiles = s.tiles_x * ((s.h + T::TH - 1) / T::TH);
  const dim3 grid(s.tiles, B);
  upconv_phase_f32_kernel<O><<<grid, NT, T::SMEM, stream>>>(x, w, bias, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_upconv_phase_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] f32 (the small grid edge-padded by 1), w [2, 2, 2, 2, C, O]
// f32 (py, px, ty, tx), bias [O] f32, out [B, 2 (Hp - 2), 2 (Wp - 2), O] f32;
// every pointer 16-byte aligned. O is 32 or 64 and C a multiple of 8 (the
// wrapper takes the net's C of 64 and 128). Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a shape the library does not take).
int stx_upconv_phase_f32(const void* x, const void* w, const void* bias, void* out, int B, int Hp,
                         int Wp, int C, int O, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out);
  if (B < 1 || B > 65535 || Hp < 3 || Wp < 3 || C < CK || C % CK != 0 || (ptrs & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 32: return run<32>(xf, wf, bf, of, B, Hp, Wp, C, st);
    case 64: return run<64>(xf, wf, bf, of, B, Hp, Wp, C, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
