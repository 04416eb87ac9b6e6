// Direct VALID convolution + bias of a pre-padded NHWC image, summed in one
// fixed order: a conv whose result for one image does not depend on the
// batch it rides in.
//
// Not the port of a TPU kernel: it takes over the convs that the JAX
// package leaves to XLA (styletransfer_tpu/models/transformer.py: the 9x9
// conv1, the stride-2 conv2 and conv3, the phase-form upsample convs and the
// space-to-depth conv_out of _apply_padearly; the 9x9 and upsampled 3x3
// convs of the stacked forward) where the caller asks for batch invariance
// (models/transformer.py, apply(fixed_order=True)): the video stylizer,
// whose every frame feeds the next, so that a clip stylized in a lane of
// `video_st convert-dir` is bit for bit the clip stylized alone. cuDNN picks
// its algorithm, and so its summation order, by the call's shape, batch
// size included, and the recurrence carries a 1e-6 difference on to whole
// steps of the uint8 output.
//   out[b, y, x, o] = sum_{ky, kx, c} x[b, y*s + ky, x*s + kx, c] * w[ky, kx, c, o]
//                     + bias[o]
// Any square kernel K, stride s, C and O; f32 or bf16 tensors, f32
// products and sums (a bf16 product is exact in f32), the bias added in f32
// and one rounding to the output type.
//
// The order: the weights HWIO, flattened, are a [K*K*C, O] matrix whose row
// r = (ky*K + kx)*C + c, and every output element is the sum over r
// ascending, one fmaf per r into one f32 accumulator starting at 0. A block
// owns TP consecutive output pixels (row-major) of ONE image by TO output
// channels; TO is a function of O alone (ops/cuda/conv_direct.py::
// direct_plan), and the batch only adds blocks (grid z). There is no
// split over r, no atomic and no reduction between threads: the result of
// an image does not depend on B or on which block runs it, and a call
// repeats bit for bit.
//
// Design (a simple kernel that is right; the tensor cores are not used): an
// implicit GEMM on the CUDA cores. Per chunk of CK rows of r, the block
// gathers its pixels' CK input values ([CK][TP] in shared memory, as f32)
// and the weights' CK rows ([CK][TO]); each thread then accumulates a PM x 4
// register tile (PM pixels, 4 channels) reading PM and 4 consecutive floats
// per row. The next chunk's loads are in flight (registers) while a chunk
// computes. For a pixel and a tap row ky, the values of r over (kx, c) are
// contiguous in memory, so the gather is coalesced: 4-element loads where C
// % 4 == 0, elements otherwise (conv1's C = 3 or 6).
//
// What bounds it on an H100: operations. The stylizer's six convs do about
// 9.9 GFLOP per 256 px image (K*K*C = 486 to 4,608 products per output) on
// a few MB; f32 FMA on the CUDA cores peaks at 67 TFLOP/s, and this kernel
// issues three shared-memory loads per 32 FMAs at TO = 64 (more per FMA at
// narrower tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int CK = 32;   // rows of r per chunk
constexpr int PN = 4;    // output channels per thread

struct Params {
  const void* x;      // [B, Hp, Wp, C]
  const void* w;      // [K, K, C, O]
  const float* bias;  // [O] or NULL
  void* out;          // [B, Ho, Wo, O]
  int Hp, Wp, C, O, K, stride, Ho, Wo;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive elements of T as floats, and four floats stored as T.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grid (ceil(Ho*Wo / TP), ceil(O / TO), B). T: the tensors' type; TO output
// channels and PM pixels per thread; VEC: 4-element x loads (C % 4 == 0).
template <typename T, int TO, int PM, bool VEC>
__global__ void __launch_bounds__(NT) direct_kernel(const Params p) {
  constexpr int COLS = TO / PN, ROWS = NT / COLS, TP = ROWS * PM;
  constexpr int XV = VEC ? 4 : 1;            // x elements per load
  constexpr int XL = CK * TP / (NT * XV);    // x loads per thread and chunk
  constexpr int WL = (CK * TO + NT - 1) / NT;  // weight loads per thread and chunk
  constexpr int QSTEP = NT / TP;             // a thread's step over the chunk's rows
  static_assert(NT % TP == 0 && XL >= 1 && CK % XV == 0, "tile");
  __shared__ __align__(16) float xs[CK][TP];
  __shared__ __align__(16) float ws[CK][TO];

  const int tid = threadIdx.x;
  const int P = p.Ho * p.Wo, C = p.C, O = p.O, K = p.K, R = K * K * C;
  const int p0 = blockIdx.x * TP, o0 = blockIdx.y * TO;
  const T* x = static_cast<const T*>(p.x) + (size_t)blockIdx.z * p.Hp * p.Wp * C;
  const T* w = static_cast<const T*>(p.w);

  // The pixel this thread gathers (the same in every chunk) and its first
  // row of the chunk.
  const int pl = tid % TP, q0 = tid / TP, pg = p0 + pl;
  const bool pin = pg < P;
  int base = 0;
  if (pin) {
    const int oy = pg / p.Wo, ox = pg - oy * p.Wo;
    base = (oy * p.stride * p.Wp + ox * p.stride) * C;
  }
  float xr[XL][XV], wr[WL];
  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int r = r0 + (q0 + i * QSTEP) * XV;
      if (pin && r < R) {
        const int tap = r / C, c = r - tap * C, ky = tap / K, kx = tap - ky * K;
        const T* src = x + base + (ky * p.Wp + kx) * C + c;
        if constexpr (VEC) {
          load4(src, xr[i]);
        } else {
          xr[i][0] = to_float(*src);
        }
      } else {
#pragma unroll
        for (int j = 0; j < XV; ++j) xr[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int e = tid + i * NT, rr = e / TO, o = o0 + e % TO, r = r0 + rr;
      wr[i] = (e < CK * TO && r < R && o < O) ? to_float(w[(size_t)r * O + o]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < XL; ++i)
#pragma unroll
      for (int j = 0; j < XV; ++j) xs[(q0 + i * QSTEP) * XV + j][pl] = xr[i][j];
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int e = tid + i * NT;
      if (e < CK * TO) ws[e / TO][e % TO] = wr[i];
    }
  };

  const int row = tid / COLS, col = tid % COLS;
  float acc[PM][PN];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j) acc[i][j] = 0.f;
  const int chunks = (R + CK - 1) / CK;
  load(0);
  for (int k = 0; k < chunks; ++k) {
    store();
    __syncthreads();
    if (k + 1 < chunks) load((k + 1) * CK);
#pragma unroll
    for (int rr = 0; rr < CK; ++rr) {
      float a[PM], b[PN];
      if constexpr (PM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < PM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&xs[rr][row * PM + i]);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
      } else if constexpr (PM == 2) {
        const float2 v = *reinterpret_cast<const float2*>(&xs[rr][row * PM]);
        a[0] = v.x;
        a[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < PM; ++i) a[i] = xs[rr][row * PM + i];
      }
      const float4 v = *reinterpret_cast<const float4*>(&ws[rr][col * PN]);
      b[0] = v.x;
      b[1] = v.y;
      b[2] = v.z;
      b[3] = v.w;
#pragma unroll
      for (int i = 0; i < PM; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The bias in f32, one rounding to T.
  const int oc = o0 + col * PN;
  float bias[PN];
#pragma unroll
  for (int j = 0; j < PN; ++j) bias[j] = (p.bias != nullptr && oc + j < O) ? p.bias[oc + j] : 0.f;
  T* out = static_cast<T*>(p.out) + (size_t)blockIdx.z * P * O;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int pix = p0 + row * PM + i;
    if (pix >= P) continue;
    float v[PN];
#pragma unroll
    for (int j = 0; j < PN; ++j) v[j] = p.bias != nullptr ? acc[i][j] + bias[j] : acc[i][j];
    T* dst = out + (size_t)pix * O + oc;
    if (O % 4 == 0 && oc + PN <= O) {
      store4(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < PN; ++j)
        if (oc + j < O) store1(dst + j, v[j]);
    }
  }
}

template <typename T, int TO, int PM>
int run(const Params& p, int B, cudaStream_t stream) {
  constexpr int TP = NT / (TO / PN) * PM;
  const dim3 grid((p.Ho * p.Wo + TP - 1) / TP, (p.O + TO - 1) / TO, B);
  if (p.C % 4 == 0)
    direct_kernel<T, TO, PM, true><<<grid, NT, 0, stream>>>(p);
  else
    direct_kernel<T, TO, PM, false><<<grid, NT, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int Hp, int Wp,
           int C, int O, int K, int stride, int to, void* stream) {
  Params p;
  p.x = x;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.Hp = Hp;
  p.Wp = Wp;
  p.C = C;
  p.O = O;
  p.K = K;
  p.stride = stride;
  p.Ho = K <= Hp && stride >= 1 ? (Hp - K) / stride + 1 : 0;
  p.Wo = K <= Wp && stride >= 1 ? (Wp - K) / stride + 1 : 0;
  // The 4-element loads and stores need 16- (f32) or 8-byte (bf16) aligned
  // x and out where C or O is a multiple of 4.
  const uintptr_t align = 4 * sizeof(T) - 1;
  if (B < 1 || B > 65535 || C < 1 || O < 1 || K < 1 || p.Ho < 1 || p.Wo < 1 ||
      (long)B * Hp * Wp * C >= (1L << 31) || (long)B * p.Ho * p.Wo * O >= (1L << 31) ||
      (C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & align) != 0) ||
      (O % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & align) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (to) {
    case 64: return run<T, 64, 8>(p, B, st);
    case 32: return run<T, 32, 4>(p, B, st);
    case 16: return run<T, 16, 2>(p, B, st);
    case 8: return run<T, 8, 1>(p, B, st);
    case 4: return run<T, 4, 1>(p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* stx_conv_direct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] and w [K, K, C, O] f32, bias [O] f32 or NULL, out [B, Ho,
// Wo, O] f32 with Ho = (Hp - K) / stride + 1 (and Wo alike), on tiles of `to`
// output channels (64, 32, 16, 8 or 4: the wrapper's plan). Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a shape or tile the
// library does not take).
int stx_conv_direct_f32(const void* x, const void* w, const void* bias, void* out, int B, int Hp,
                        int Wp, int C, int O, int K, int stride, int to, void* stream) {
  return launch<float>(x, w, bias, out, B, Hp, Wp, C, O, K, stride, to, stream);
}

// As stx_conv_direct_f32 with x, w and out in bf16 (bias stays f32).
int stx_conv_direct_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                         int Hp, int Wp, int C, int O, int K, int stride, int to, void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, out, B, Hp, Wp, C, O, K, stride, to, stream);
}

}  // extern "C"
