// Backward of the fused instance norm (+ residual) (+ ReLU).
//
// Replaces the backward of the TPU kernel styletransfer_tpu/ops/pallas/
// instance_norm.py (fused_instance_norm -> _fused, whose custom VJP _fused_bwd
// takes jax.vjp of _xla_reference). With the forward's saved statistics
// (csrc/instance_norm.cu at pad 0 returns mean and inv = rsqrt(var + eps)):
//   s      = x + residual                  (f32, as the forward adds it)
//   xhat   = (s - mean) * inv
//   gm     = g, zeroed where xhat * scale + bias <= 0 when the forward had a ReLU
//   S1     = sum_hw gm,   S2 = sum_hw gm * xhat       (per image and channel, f32)
//   dx     = inv * scale * (gm - S1 / HW - xhat * S2 / HW)   (in x's type;
//            it is also dresidual)
//   dscale = sum_n S2,    dbias = sum_n S1           (f32)
// The mask is computed with explicitly rounded operations (no fused
// multiply-add), so it is bit for bit the mask of the plain PyTorch version
// given the same statistics.
//
// What bounds it on an H100: bytes. A few operations per element against
// reading x (and the residual) and g and writing dx. The training forward's
// largest call ([4, 256, 256, 32], f32) moves 67 MB in and 34 MB out, 0.03 ms
// at 3.35 TB/s; at that size a call is also short enough that the host's
// launch of it can take longer than the card's run (PERF.md).
//
// Design: an image (up to 65,536 pixels) does not fit in one block's shared
// memory, and blocks run in no order, so the two reductions are split into
// deterministic passes without atomics, as in the forward's statistics:
//   1. inb_partial: grid (G, N); each block reduces one chunk of pixels of
//      one image. A thread owns four channels and strides over pixels,
//      keeping (S1, S2); the block adds its threads in a fixed order and
//      writes part[n, g, c, 0..1].
//   2. inb_finalize: one warp per channel. For each image the lanes add the
//      chunk partials at a fixed stride, a xor-shuffle tree (the same on
//      every lane) adds the lanes, and lane 0 writes S1, S2 and carries the
//      sums over images for dscale and dbias.
//   3. inb_dx: one thread per (pixel, four channels) recomputes xhat and the
//      mask and writes dx; 16-byte (f32) or 8-byte (bf16) loads and stores.
// x, the residual and g are read twice (passes 1 and 3); the bound counts
// them once. A single-read design would keep an image on chip across a
// cluster of blocks (distributed shared memory): later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// s = x (+ residual) at flat element offset off (four channels), in f32.
template <typename T>
__device__ __forceinline__ float4 load_sum(const T* __restrict__ x, const T* __restrict__ res,
                                           size_t off) {
  float4 v = load4(x + off);
  if (res != nullptr) {
    const float4 r = load4(res + off);
    v.x += r.x;
    v.y += r.y;
    v.z += r.z;
    v.w += r.w;
  }
  return v;
}

// xhat and the masked gradient of one element, rounded as the plain version
// rounds: xhat = (s - mean) * inv, pre = xhat * scale + bias.
__device__ __forceinline__ void xhat_gm(float s, float mu, float iv, float ga, float be,
                                        float g, int relu, float& xh, float& gm) {
  xh = __fmul_rn(__fsub_rn(s, mu), iv);
  gm = (relu && !(__fadd_rn(__fmul_rn(xh, ga), be) > 0.f)) ? 0.f : g;
}

struct Chan4 {
  float4 mu, iv, ga, be;
};

__device__ __forceinline__ Chan4 load_chan(const float* mean, const float* inv,
                                           const float* scale, const float* bias, int n,
                                           int C, int c) {
  Chan4 k;
  k.mu = load4(mean + (size_t)n * C + c);
  k.iv = load4(inv + (size_t)n * C + c);
  k.ga = load4(scale + c);
  k.be = load4(bias + c);
  return k;
}

// grid (G, N): block gi reduces pixels [gi*chunk, min(HW, (gi+1)*chunk)) of
// image n. part[n, gi, c, 0..1] = (S1, S2) of that chunk.
template <typename T>
__global__ void __launch_bounds__(NT)
inb_partial(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ g,
            const float* __restrict__ mean, const float* __restrict__ inv,
            const float* __restrict__ scale, const float* __restrict__ bias, int HW, int C,
            int relu, int chunk, float* __restrict__ part) {
  __shared__ float4 sh1[NT];
  __shared__ float4 sh2[NT];
  const int G = gridDim.x, gi = blockIdx.x, n = blockIdx.y;
  const int C4 = C / 4;
  const int ppi = NT / C4;  // pixels per iteration of the block
  const int tid = threadIdx.x;
  const int c4 = tid % C4, lp = tid / C4;
  const int pb = gi * chunk;
  const int pe = min(HW, pb + chunk);

  float4 s1 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s2 = s1;
  if (lp < ppi) {
    const int c = c4 * 4;
    const Chan4 k = load_chan(mean, inv, scale, bias, n, C, c);
    for (int p = pb + lp; p < pe; p += ppi) {
      const size_t off = ((size_t)n * HW + p) * C + c;
      const float4 s = load_sum(x, res, off);
      const float4 gg = load4(g + off);
      float xh, gm;
      xhat_gm(s.x, k.mu.x, k.iv.x, k.ga.x, k.be.x, gg.x, relu, xh, gm);
      s1.x += gm; s2.x += gm * xh;
      xhat_gm(s.y, k.mu.y, k.iv.y, k.ga.y, k.be.y, gg.y, relu, xh, gm);
      s1.y += gm; s2.y += gm * xh;
      xhat_gm(s.z, k.mu.z, k.iv.z, k.ga.z, k.be.z, gg.z, relu, xh, gm);
      s1.z += gm; s2.z += gm * xh;
      xhat_gm(s.w, k.mu.w, k.iv.w, k.ga.w, k.be.w, gg.w, relu, xh, gm);
      s1.w += gm; s2.w += gm * xh;
    }
  }
  sh1[tid] = s1;
  sh2[tid] = s2;
  __syncthreads();
  if (tid < C4) {
    float4 a = sh1[tid], b = sh2[tid];
    for (int j = 1; j < ppi; ++j) {
      const float4 u = sh1[j * C4 + tid], v = sh2[j * C4 + tid];
      a.x += u.x; a.y += u.y; a.z += u.z; a.w += u.w;
      b.x += v.x; b.y += v.y; b.z += v.z; b.w += v.w;
    }
    float* o = part + (((size_t)n * G + gi) * C + tid * 4) * 2;
    o[0] = a.x; o[1] = b.x;
    o[2] = a.y; o[3] = b.y;
    o[4] = a.z; o[5] = b.z;
    o[6] = a.w; o[7] = b.w;
  }
}

// grid C, one warp each: S1/S2 [N, C] from the G chunk partials of each
// image, and dscale/dbias [C] summed over the images in order.
__global__ void __launch_bounds__(32)
inb_finalize(const float* __restrict__ part, int N, int G, int C, float* __restrict__ s1,
             float* __restrict__ s2, float* __restrict__ dscale, float* __restrict__ dbias) {
  const int c = blockIdx.x, lane = threadIdx.x;
  float ds = 0.f, db = 0.f;
  for (int n = 0; n < N; ++n) {
    float a = 0.f, b = 0.f;
    for (int gi = lane; gi < G; gi += 32) {
      const float* p = part + (((size_t)n * G + gi) * C + c) * 2;
      a += p[0];
      b += p[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      s1[(size_t)n * C + c] = a;
      s2[(size_t)n * C + c] = b;
    }
    db += a;
    ds += b;
  }
  if (lane == 0) {
    dscale[c] = ds;
    dbias[c] = db;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
inb_dx(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ g,
       const float* __restrict__ mean, const float* __restrict__ inv,
       const float* __restrict__ scale, const float* __restrict__ bias,
       const float* __restrict__ s1, const float* __restrict__ s2, int N, int HW, int C,
       int relu, T* __restrict__ dx) {
  const int C4 = C / 4;
  const size_t total = (size_t)N * HW * C4;
  const float rhw = 1.f / (float)HW;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C4) * 4;
    const int n = (int)(i / C4 / HW);
    const size_t off = i * 4;
    const float4 s = load_sum(x, res, off);
    const float4 gg = load4(g + off);
    const Chan4 k = load_chan(mean, inv, scale, bias, n, C, c);
    const float4 a = load4(s1 + (size_t)n * C + c);
    const float4 b = load4(s2 + (size_t)n * C + c);
    float4 o;
    float xh, gm;
    xhat_gm(s.x, k.mu.x, k.iv.x, k.ga.x, k.be.x, gg.x, relu, xh, gm);
    o.x = k.iv.x * k.ga.x * (gm - a.x * rhw - xh * (b.x * rhw));
    xhat_gm(s.y, k.mu.y, k.iv.y, k.ga.y, k.be.y, gg.y, relu, xh, gm);
    o.y = k.iv.y * k.ga.y * (gm - a.y * rhw - xh * (b.y * rhw));
    xhat_gm(s.z, k.mu.z, k.iv.z, k.ga.z, k.be.z, gg.z, relu, xh, gm);
    o.z = k.iv.z * k.ga.z * (gm - a.z * rhw - xh * (b.z * rhw));
    xhat_gm(s.w, k.mu.w, k.iv.w, k.ga.w, k.be.w, gg.w, relu, xh, gm);
    o.w = k.iv.w * k.ga.w * (gm - a.w * rhw - xh * (b.w * rhw));
    store4(dx + off, o);
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* g, const void* mean, const void* inv,
           const void* scale, const void* bias, void* part, void* s1, void* s2, void* dscale,
           void* dbias, void* dx, int N, int HW, int C, int relu, int G, int chunk,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const T* gt = static_cast<const T*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float* s1p = static_cast<float*>(s1);
  float* s2p = static_cast<float*>(s2);
  inb_partial<T><<<dim3(G, N), NT, 0, st>>>(xt, rt, gt, mp, ip, sp, bp, HW, C, relu, chunk, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  inb_finalize<<<C, 32, 0, st>>>(pp, N, G, C, s1p, s2p, static_cast<float*>(dscale),
                                 static_cast<float*>(dbias));
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  const size_t total = (size_t)N * HW * (C / 4);
  const size_t want = (total + NT - 1) / NT;
  const unsigned blocks = (unsigned)(want < (1u << 20) ? want : (1u << 20));
  inb_dx<T><<<blocks, NT, 0, st>>>(xt, rt, gt, mp, ip, sp, bp, s1p, s2p, N, HW, C, relu,
                                    static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_instance_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, g, dx [N, H, W, C] (HW = H * W); res the same or NULL; mean/inv [N, C]
// f32 from the forward; scale/bias [C] f32; part [N, G, C, 2] f32 scratch
// for G chunks of `chunk` pixels; s1/s2 [N, C] f32 scratch; dscale/dbias [C]
// f32 outputs. dx NULL skips the dx pass. C % 4 == 0.
int stx_in_bwd_f32(const void* x, const void* res, const void* g, const void* mean,
                   const void* inv, const void* scale, const void* bias, void* part, void* s1,
                   void* s2, void* dscale, void* dbias, void* dx, int N, int HW, int C,
                   int relu, int G, int chunk, void* stream) {
  return launch<float>(x, res, g, mean, inv, scale, bias, part, s1, s2, dscale, dbias, dx, N,
                       HW, C, relu, G, chunk, stream);
}

// As stx_in_bwd_f32 with x, res, g and dx in bf16.
int stx_in_bwd_bf16(const void* x, const void* res, const void* g, const void* mean,
                    const void* inv, const void* scale, const void* bias, void* part, void* s1,
                    void* s2, void* dscale, void* dbias, void* dx, int N, int HW, int C,
                    int relu, int G, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, res, g, mean, inv, scale, bias, part, s1, s2, dscale, dbias,
                               dx, N, HW, C, relu, G, chunk, stream);
}

}  // extern "C"
