// Instance norm (+ residual) (+ ReLU) writing its output already padded for
// the next convolution.
//
// Replaces the TPU kernel styletransfer_tpu/ops/pallas/instance_norm.py
// (fused_instance_norm_padded -> _kernel_padded), and extends it with what
// the pad-early forward (styletransfer_tpu/models/transformer.py, _in_pad)
// needs beyond it: edge padding, and statistics handed in by the conv3x3
// kernel instead of computed here.
//   s   = x + residual[interior]      (with res_f32 == 0 the sum is rounded
//                                       to the storage type, as the JAX
//                                       pad-early forward adds in h.dtype;
//                                       with res_f32 == 1 it stays f32, as
//                                       fused_instance_norm's _kernel adds)
//   out = pad(relu?((s - mean) * rsqrt(var + eps) * scale + bias))
// The same kernels at pad 0 with res_f32 == 1 are the forward of
// fused_instance_norm (_pallas_forward -> _kernel / _kernel_with_res) for the
// training forward: mean and inv go back to the caller, which keeps them for
// the backward (csrc/instance_norm_bwd.cu). One forward serves both paths,
// so the training forward needs no second kernel.
// With no statistics given, var is the exact centered variance, as in the
// TPU kernel; with (sums, sumsqs) it is the one-pass form clamped at 0, as
// in styletransfer_tpu/ops/layers.py instance_norm_stats.
//
// What bounds it on an H100: bytes. It does a few operations per element,
// far below the ~20 FLOP/byte (f32) where the card stops being bound by
// memory. The largest call of the forward ([64, 256, 256, 32] -> pad 1) moves
// 537 MB in and 545 MB out in f32.
//
// Design: the TPU kernel held one whole image in VMEM and reduced it in one
// grid step. A Hopper block cannot see a whole image and blocks run in no
// order, so the reduction is split:
//   1. in_partial_stats: each block reduces one chunk of pixels of one image,
//      every thread keeping a Welford (count, mean, M2) for four channels,
//      merged inside the block in a fixed order with Chan's formula.
//   2. in_finalize_*: one thread per (image, channel) merges the chunks in
//      order (or turns the conv's sums into mean / variance).
//   3. in_apply_pad: one thread per (output pixel, four channels) maps its
//      output coordinate to a source pixel (reflect or edge), recomputes s
//      and writes the normalized value. Loads and stores are 16 bytes (f32)
//      or 8 bytes (bf16) per thread, neighbouring threads on neighbouring
//      channels.
// The result is deterministic. Pass 1 re-reads x in pass 3 (the bound counts
// it once); fusing the two for images that fit in shared memory is later work.

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

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Dims {
  int N, H, W, C, rp;  // rp: padding of the residual tensor (its interior is used)
  int res_f32;         // 1: add the residual in f32; 0: round the sum to T
};

// s = x (+ residual interior) at pixel (n, y, x), channels c..c+3.
template <typename T>
__device__ __forceinline__ float4 load_sum(const T* __restrict__ x,
                                           const T* __restrict__ res, const Dims& d,
                                           int n, int y, int xx, int c) {
  float4 v = load4(x + (((size_t)n * d.H + y) * d.W + xx) * d.C + c);
  if (res != nullptr) {
    const int Hr = d.H + 2 * d.rp, Wr = d.W + 2 * d.rp;
    const float4 r =
        load4(res + (((size_t)n * Hr + y + d.rp) * Wr + xx + d.rp) * d.C + c);
    v.x += r.x;
    v.y += r.y;
    v.z += r.z;
    v.w += r.w;
    if (!d.res_f32) {
      const T* tag = nullptr;
      v.x = round_to(v.x, tag);
      v.y = round_to(v.y, tag);
      v.z = round_to(v.z, tag);
      v.w = round_to(v.w, tag);
    }
  }
  return v;
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a, float nb,
                                           float mb, float m2b) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float delta = mb - ma;
  ma += delta * (nb / n);
  m2a += m2b + delta * delta * (na * nb / n);
  na = n;
}

// grid (G, N): block g reduces pixels [g*chunk, min(HW, (g+1)*chunk)) of image n.
// part[n, g, c, 0..2] = (count, mean, M2).
template <typename T>
__global__ void __launch_bounds__(NT)
in_partial_stats(const T* __restrict__ x, const T* __restrict__ res, Dims d, int chunk,
                 float* __restrict__ part) {
  __shared__ float sh_n[NT];
  __shared__ float4 sh_mean[NT];
  __shared__ float4 sh_m2[NT];

  const int G = gridDim.x, g = blockIdx.x, n = blockIdx.y;
  const int C4 = d.C / 4;
  const int ppi = NT / C4;  // pixels per iteration of the block
  const int tid = threadIdx.x;
  const int c4 = tid % C4, lp = tid / C4;
  const int HW = d.H * d.W;
  const int pb = g * chunk;
  const int pe = min(HW, pb + chunk);

  float cnt = 0.f;
  float4 mean = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 m2 = mean;
  if (lp < ppi) {
    for (int p = pb + lp; p < pe; p += ppi) {
      const int y = p / d.W, xx = p - (p / d.W) * d.W;
      const float4 v = load_sum(x, res, d, n, y, xx, c4 * 4);
      cnt += 1.f;
      const float r = 1.f / cnt;
      float dl;
      dl = v.x - mean.x; mean.x += dl * r; m2.x += dl * (v.x - mean.x);
      dl = v.y - mean.y; mean.y += dl * r; m2.y += dl * (v.y - mean.y);
      dl = v.z - mean.z; mean.z += dl * r; m2.z += dl * (v.z - mean.z);
      dl = v.w - mean.w; mean.w += dl * r; m2.w += dl * (v.w - mean.w);
    }
  }
  sh_n[tid] = cnt;
  sh_mean[tid] = mean;
  sh_m2[tid] = m2;
  __syncthreads();
  if (tid < C4) {
    float na = sh_n[tid];
    float4 ma = sh_mean[tid], qa = sh_m2[tid];
    for (int j = 1; j < ppi; ++j) {
      const int t = j * C4 + tid;
      const float nb = sh_n[t];
      const float4 mb = sh_mean[t], qb = sh_m2[t];
      float nn;
      nn = na; chan_merge(nn, ma.x, qa.x, nb, mb.x, qb.x);
      nn = na; chan_merge(nn, ma.y, qa.y, nb, mb.y, qb.y);
      nn = na; chan_merge(nn, ma.z, qa.z, nb, mb.z, qb.z);
      nn = na; chan_merge(nn, ma.w, qa.w, nb, mb.w, qb.w);
      na = nn;
    }
    float* o = part + (((size_t)n * G + g) * d.C + tid * 4) * 3;
    const float m[4] = {ma.x, ma.y, ma.z, ma.w};
    const float q[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[3 * k + 0] = na;
      o[3 * k + 1] = m[k];
      o[3 * k + 2] = q[k];
    }
  }
}

// One thread per (n, c): merge the G chunk partials in order.
__global__ void in_finalize_partials(const float* __restrict__ part, int N, int G, int C,
                                     float eps, float* __restrict__ mean,
                                     float* __restrict__ inv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * C) return;
  const int n = i / C, c = i - (i / C) * C;
  float na = 0.f, ma = 0.f, qa = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* p = part + (((size_t)n * G + g) * C + c) * 3;
    chan_merge(na, ma, qa, p[0], p[1], p[2]);
  }
  mean[i] = ma;
  inv[i] = 1.f / sqrtf(qa / na + eps);
}

// One thread per (n, c): the one-pass clamped form from the conv's sums.
__global__ void in_finalize_sums(const float* __restrict__ sums,
                                 const float* __restrict__ sumsqs, int NC, float count,
                                 float eps, float* __restrict__ mean,
                                 float* __restrict__ inv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NC) return;
  const float m = sums[i] / count;
  const float var = fmaxf(sumsqs[i] / count - m * m, 0.f);
  mean[i] = m;
  inv[i] = 1.f / sqrtf(var + eps);
}

__device__ __forceinline__ int source_index(int i, int L, int edge) {
  if (edge) return min(max(i, 0), L - 1);
  if (i < 0) return -i;
  if (i >= L) return 2 * (L - 1) - i;
  return i;
}

template <typename T>
__global__ void __launch_bounds__(NT)
in_apply_pad(const T* __restrict__ x, const T* __restrict__ res, Dims d,
             const float* __restrict__ mean, const float* __restrict__ inv,
             const float* __restrict__ scale, const float* __restrict__ bias,
             T* __restrict__ out, int pad, int edge, int relu) {
  const int C4 = d.C / 4;
  const int Ho = d.H + 2 * pad, Wo = d.W + 2 * pad;
  const size_t total = (size_t)d.N * Ho * Wo * C4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C4) * 4;
    size_t q = i / C4;
    const int ox = (int)(q % Wo);
    q /= Wo;
    const int oy = (int)(q % Ho);
    const int n = (int)(q / Ho);
    const int sy = source_index(oy - pad, d.H, edge);
    const int sx = source_index(ox - pad, d.W, edge);
    const float4 s = load_sum(x, res, d, n, sy, sx, c);
    const float4 mu = load4(mean + (size_t)n * d.C + c);
    const float4 iv = load4(inv + (size_t)n * d.C + c);
    const float4 ga = load4(scale + c);
    const float4 be = load4(bias + c);
    float4 o;
    o.x = (s.x - mu.x) * iv.x * ga.x + be.x;
    o.y = (s.y - mu.y) * iv.y * ga.y + be.y;
    o.z = (s.z - mu.z) * iv.z * ga.z + be.z;
    o.w = (s.w - mu.w) * iv.w * ga.w + be.w;
    if (relu) {
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
      o.z = fmaxf(o.z, 0.f);
      o.w = fmaxf(o.w, 0.f);
    }
    store4(out + i * 4, o);
  }
}

template <typename T>
int launch(const void* x, const void* res, int res_pad, int res_f32, const void* sums,
           const void* sumsqs, const void* scale, const void* bias, void* out, void* part,
           void* mean, void* inv, int N, int H, int W, int C, int pad, int edge, int relu,
           float eps, int G, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dims d;
  d.N = N;
  d.H = H;
  d.W = W;
  d.C = C;
  d.rp = res_pad;
  d.res_f32 = res_f32;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  float* mp = static_cast<float*>(mean);
  float* ip = static_cast<float*>(inv);
  const int NC = N * C;
  cudaError_t err;
  if (sums != nullptr) {
    in_finalize_sums<<<(NC + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(sums), static_cast<const float*>(sumsqs), NC,
        static_cast<float>(H) * static_cast<float>(W), eps, mp, ip);
  } else {
    in_partial_stats<T><<<dim3(G, N), NT, 0, st>>>(xt, rt, d, chunk,
                                                   static_cast<float*>(part));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in_finalize_partials<<<(NC + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                            N, G, C, eps, mp, ip);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)N * (H + 2 * pad) * (W + 2 * pad) * (C / 4);
  const size_t want = (total + NT - 1) / NT;
  const unsigned blocks = (unsigned)(want < (1u << 20) ? want : (1u << 20));
  in_apply_pad<T><<<blocks, NT, 0, st>>>(xt, rt, d, mp, ip, static_cast<const float*>(scale),
                                         static_cast<const float*>(bias),
                                         static_cast<T*>(out), pad, edge, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_instance_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [N, H, W, C]; res [N, H+2*res_pad, W+2*res_pad, C] or NULL, its interior
// added in f32 (res_f32 = 1) or rounded to x's type (res_f32 = 0); sums/sumsqs
// [N, C] f32 or NULL (then part [N, G, C, 3] f32 scratch holds the chunk
// statistics of G chunks of `chunk` pixels); scale/bias [C] f32; mean/inv
// [N, C] f32 outputs; out [N, H+2*pad, W+2*pad, C]. C % 4 == 0, C <= 1024.
int stx_in_pad_f32(const void* x, const void* res, int res_pad, int res_f32, const void* sums,
                   const void* sumsqs, const void* scale, const void* bias, void* out,
                   void* part, void* mean, void* inv, int N, int H, int W, int C, int pad,
                   int edge, int relu, float eps, int G, int chunk, void* stream) {
  return launch<float>(x, res, res_pad, res_f32, sums, sumsqs, scale, bias, out, part, mean, inv, N,
                       H, W, C, pad, edge, relu, eps, G, chunk, stream);
}

// As stx_in_pad_f32 with x, res and out in bf16.
int stx_in_pad_bf16(const void* x, const void* res, int res_pad, int res_f32, const void* sums,
                    const void* sumsqs, const void* scale, const void* bias, void* out,
                    void* part, void* mean, void* inv, int N, int H, int W, int C, int pad,
                    int edge, int relu, float eps, int G, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, res, res_pad, res_f32, sums, sumsqs, scale, bias, out, part, mean,
                               inv, N, H, W, C, pad, edge, relu, eps, G, chunk, stream);
}

}  // extern "C"
