// 3x3 VALID convolution + bias (+ReLU) with per-image instance-norm sums.
//
// Replaces the TPU kernel styletransfer_tpu/ops/pallas/conv3x3.py
// (conv3x3_valid -> _call -> _kernel): out[b, y, x, o] =
//   sum_{dy,dx,c} xpad[b, y+dy, x+dx, c] * w[dy, dx, c, o] + bias[o]
// on an input that the previous instance norm already wrote padded, plus
// sums[b, o] and sumsqs[b, o] of the post-activation f32 accumulator (taken
// before the cast to the output type), ready for the next instance norm.
//
// What bounds it on an H100: the residual-stack call ([64, 66, 66, 128] ->
// [64, 64, 64, 128]) is 77.3 GFLOP against 277 MB in f32, so it is bound by
// operations in both types: f32 has no tensor-core path here (TF32 is not
// allowed, it would drift from the f32 reference), and bf16 is bound by the
// tensor cores.
//
// Design: a tiled implicit GEMM over [B*H*W] x [9*C] -> [O]. A block owns
// 128 output pixels of ONE image and 128 output channels; the K loop walks
// the nine taps, and a K tile never straddles a tap (C % 32 == 0), so each
// tile row is a contiguous run of channels of one shifted input pixel. The
// shifted rows and the weight tile are staged in shared memory.
//   f32:  FMA on an 8x8 register tile per thread (256 threads, BK = 16),
//         one tile in shared memory at a time.
//   bf16: mma.sync m16n8k16 with f32 accumulation (8 warps, each 32x64,
//         BK = 32). Tiles arrive through a 3-stage cp.async ring, so loads
//         run two K tiles ahead of the tensor cores, and fragments are read
//         with ldmatrix (.trans for the weights, which stay [k][n] as they
//         lie in global memory).
// The TPU kernel carried the sums inside one grid step per image. Hopper
// blocks run in parallel and in no order, so each block writes its per-tile
// column partials and a second small kernel adds the tiles of an image in
// a fixed order: the sums are deterministic, with no atomics.
// Not yet used: TMA, wgmma and warp specialisation (the way to the bf16
// tensor-core peak), and a copy pipeline for the f32 path.

#include "conv3x3_common.cuh"

namespace {

using conv3x3::ldmatrix_x4;
using conv3x3::ldmatrix_x4_trans;
using conv3x3::mma_bf16_16816;
using conv3x3::smem_addr;

constexpr int BM = 128;  // output pixels per block (all in one image)
constexpr int BN = 128;  // output channels per block
constexpr int NT = 256;  // threads per block

struct Shape {
  int Hp, Wp, C, O, W, HW, tiles;
};

// ---------------------------------------------------------------- f32 path
constexpr int BK_F32 = 16;

__device__ __forceinline__ int split_index(int t, int i) {
  // Rows (or columns) i = 0..7 of a thread: t*4 + {0..3} and 64 + t*4 + {0..3}.
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__global__ void __launch_bounds__(NT)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ psum, float* __restrict__ psq,
                   Shape s, int relu) {
  __shared__ __align__(16) float As[BK_F32][BM];  // As[k][m]
  __shared__ __align__(16) float Bs[BK_F32][BN];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int tile = blockIdx.x - img * s.tiles;
  const int p0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + (size_t)img * s.Hp * s.Wp * s.C;
  const int K = 9 * s.C;

  // A loader: rows tid/4 and tid/4 + 64, four channels at (tid%4)*4.
  const int a_k = (tid & 3) * 4;
  size_t a_base[2];
  bool a_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + (tid >> 2) + 64 * j;
    a_ok[j] = p < s.HW;
    const int py = a_ok[j] ? p / s.W : 0;
    const int px = a_ok[j] ? p - py * s.W : 0;
    a_base[j] = ((size_t)py * s.Wp + px) * s.C;
  }
  // B loader: rows tid/32 and tid/32 + 8, four channels at (tid%32)*4.
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  const bool b_ok = n0 + b_n < s.O;

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += BK_F32) {
    const int tap = k0 / s.C;
    const int c0 = k0 - tap * s.C;
    const int dy = tap / 3, dx = tap - (tap / 3) * 3;
    const size_t toff = ((size_t)dy * s.Wp + dx) * s.C + c0 + a_k;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 v =
          a_ok[j] ? *reinterpret_cast<const float4*>(xb + a_base[j] + toff) : zero;
      const int m = (tid >> 2) + 64 * j;
      As[a_k + 0][m] = v.x;
      As[a_k + 1][m] = v.y;
      As[a_k + 2][m] = v.z;
      As[a_k + 3][m] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = b_k + 8 * j;
      const float4 v =
          b_ok ? *reinterpret_cast<const float4*>(w + (size_t)(k0 + kk) * s.O + n0 + b_n)
               : zero;
      *reinterpret_cast<float4*>(&Bs[kk][b_n]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK_F32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias, ReLU, store, and this thread's column partials.
  float bcol[8], cs[8], cq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + split_index(tx, j);
    bcol[j] = n < s.O ? bias[n] : 0.f;
    cs[j] = 0.f;
    cq[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + split_index(ty, i);
    if (p >= s.HW) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[i][j] + bcol[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
      cs[j] += v[j];
      cq[j] += v[j] * v[j];
    }
    float* orow = out + ((size_t)img * s.HW + p) * s.O + n0;
    if (n0 + tx * 4 < s.O)
      *reinterpret_cast<float4*>(orow + tx * 4) = make_float4(v[0], v[1], v[2], v[3]);
    if (n0 + 64 + tx * 4 < s.O)
      *reinterpret_cast<float4*>(orow + 64 + tx * 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  // Column partials: 16 row groups (ty) per column, added in a fixed order.
  // The main loop ended with __syncthreads(), so As/Bs are free.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    As[ty][split_index(tx, j)] = cs[j];
    Bs[ty][split_index(tx, j)] = cq[j];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < s.O) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < 16; ++r) {
      ts += As[r][tid];
      tq += Bs[r][tid];
    }
    const size_t o = ((size_t)img * s.tiles + tile) * s.O + n0 + tid;
    psum[o] = ts;
    psq[o] = tq;
  }
}

// --------------------------------------------------------------- bf16 path
constexpr int BK_BF16 = 32;
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int A_LD = BK_BF16 + 8;  // As row pitch in bf16: 80 bytes, ldmatrix conflict-free
constexpr int B_LD = BN + 8;       // Bs row pitch in bf16: 272 bytes, ldmatrix conflict-free
constexpr int A_STAGE = BM * A_LD;       // bf16 elements per stage
constexpr int B_STAGE = BK_BF16 * B_LD;
constexpr size_t BF16_SMEM = (size_t)STAGES * (A_STAGE + B_STAGE) * 2;  // 56,832 bytes

// 16-byte global -> shared copy; src_bytes == 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory (dynamic, STAGES deep): As[stage][m][k] (shifted input rows)
// and Bs[stage][k][n] (weights as they lie in global memory). Tiles arrive
// by cp.async, STAGES - 1 K tiles ahead of the tensor cores; fragments are
// read with ldmatrix (.trans for the weights).
__global__ void __launch_bounds__(NT)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ psum, float* __restrict__ psq, Shape s,
                    int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int img = blockIdx.x / s.tiles;
  const int tile = blockIdx.x - img * s.tiles;
  const int p0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + (size_t)img * s.Hp * s.Wp * s.C;
  const int KT = 9 * s.C / BK_BF16;

  // A loader: rows tid/4 and tid/4 + 64, eight channels at (tid%4)*8.
  const int a_k = (tid & 3) * 8;
  size_t a_base[2];
  int a_bytes[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + (tid >> 2) + 64 * j;
    const bool ok = p < s.HW;
    const int py = ok ? p / s.W : 0;
    const int px = ok ? p - py * s.W : 0;
    a_base[j] = ((size_t)py * s.Wp + px) * s.C + a_k;
    a_bytes[j] = ok ? 16 : 0;
  }
  // B loader: k rows tid/16 and tid/16 + 16, eight channels at (tid%16)*8.
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 8;
  const int b_bytes = n0 + b_n < s.O ? 16 : 0;
  const __nv_bfloat16* wb = w + (b_bytes ? n0 + b_n : 0);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK_BF16;
    const int tap = k0 / s.C;
    const int c0 = k0 - tap * s.C;
    const int dy = tap / 3, dx = tap - (tap / 3) * 3;
    const size_t toff = ((size_t)dy * s.Wp + dx) * s.C + c0;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat16* src = a_bytes[j] ? xb + a_base[j] + toff : xb;
      cp_async16(as + ((tid >> 2) + 64 * j) * A_LD + a_k, src, a_bytes[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = b_k + 16 * j;
      cp_async16(bs + kk * B_LD + b_n, wb + (size_t)(k0 + kk) * s.O, b_bytes);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: lanes 0-15 give rows 0-15 of the first eight
  // columns, lanes 16-31 the same rows of the next eight.
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // K tile kt has landed (for this thread)
    __syncthreads();              // ... for every thread; tile kt-1 is consumed
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* as = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK_BF16; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + lrow) * A_LD + kk + lcol);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // b[0..1]: n tile 2*np, b[2..3]: n tile 2*np + 1
        ldmatrix_x4_trans(b, bs + (kk + lrow) * B_LD + wn * 64 + np * 16 + lcol);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16_16816(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // shared memory is reused for the column sums below

  // Epilogue. Accumulator fragment: e = 0,1 -> row g, cols t4*2 + {0,1};
  // e = 2,3 -> row g + 8.
  float cs[8][2], cq[8][2], bc[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn * 64 + ni * 8 + t4 * 2 + h;
      bc[ni][h] = n < s.O ? bias[n] : 0.f;
      cs[ni][h] = 0.f;
      cq[ni][h] = 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 32 + mi * 16 + g + half * 8;
      if (p >= s.HW) continue;
      __nv_bfloat16* orow = out + ((size_t)img * s.HW + p) * s.O;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float v0 = acc[mi][ni][half * 2 + 0] + bc[ni][0];
        float v1 = acc[mi][ni][half * 2 + 1] + bc[ni][1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        cs[ni][0] += v0;
        cs[ni][1] += v1;
        cq[ni][0] += v0 * v0;
        cq[ni][1] += v1 * v1;
        const int n = n0 + wn * 64 + ni * 8 + t4 * 2;
        if (n < s.O)
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  // Add the eight row groups (g) of a warp by a fixed butterfly; lanes with
  // g == 0 then hold the warp's column sums. The four warps along M are added
  // in order through shared memory.
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        cs[ni][h] += __shfl_xor_sync(0xffffffffu, cs[ni][h], m);
        cq[ni][h] += __shfl_xor_sync(0xffffffffu, cq[ni][h], m);
      }
  float* red = reinterpret_cast<float*>(smem_raw);  // [2][4][BN] floats = 4 KB
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = wn * 64 + ni * 8 + t4 * 2 + h;
        red[wm * BN + col] = cs[ni][h];
        red[4 * BN + wm * BN + col] = cq[ni][h];
      }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < s.O) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < 4; ++r) {
      ts += red[r * BN + tid];
      tq += red[4 * BN + r * BN + tid];
    }
    const size_t o = ((size_t)img * s.tiles + tile) * s.O + n0 + tid;
    psum[o] = ts;
    psq[o] = tq;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* x, const void* w, const void* bias,
           void* out, void* psum, void* psq, void* sums, void* sumsqs, int B, int Hp, int Wp,
           int C, int O, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Shape s;
  s.Hp = Hp;
  s.Wp = Wp;
  s.C = C;
  s.O = O;
  s.W = Wp - 2;
  s.HW = (Hp - 2) * (Wp - 2);
  s.tiles = (s.HW + BM - 1) / BM;
  const dim3 grid(B * s.tiles, (O + BN - 1) / BN);
  kernel<<<grid, NT, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                              static_cast<const float*>(bias), static_cast<T*>(out),
                              static_cast<float*>(psum), static_cast<float*>(psq), s, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv3x3::tile_sums(
      static_cast<const float*>(psum), static_cast<const float*>(psq), static_cast<float*>(sums),
      static_cast<float*>(sumsqs), B, s.tiles, O, st));
}

}  // namespace

extern "C" {

const char* stx_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C], w [3, 3, C, O] (both f32), bias [O] f32, out [B, Hp-2, Wp-2, O]
// f32, psum/psq [B, tiles, O] f32 scratch, sums/sumsqs [B, O] f32.
int stx_conv3x3_f32(const void* x, const void* w, const void* bias, void* out, void* psum,
                    void* psq, void* sums, void* sumsqs, int B, int Hp, int Wp, int C,
                    int O, int relu, void* stream) {
  return launch<float>(conv3x3_f32_kernel, 0, x, w, bias, out, psum, psq, sums, sumsqs, B, Hp,
                       Wp, C, O, relu, stream);
}

// As stx_conv3x3_f32 with x, w and out in bf16 (bias and the sums stay f32).
int stx_conv3x3_bf16(const void* x, const void* w, const void* bias, void* out, void* psum,
                     void* psq, void* sums, void* sumsqs, int B, int Hp, int Wp, int C,
                     int O, int relu, void* stream) {
  return launch<__nv_bfloat16>(conv3x3_bf16_kernel, BF16_SMEM, x, w, bias, out, psum, psq, sums,
                               sumsqs, B, Hp, Wp, C, O, relu, stream);
}

}  // extern "C"
