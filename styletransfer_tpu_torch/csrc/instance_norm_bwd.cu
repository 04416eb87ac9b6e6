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
//   dscale = sum_n S2,    dbias = sum_n S1           (f32; [C] affines)
//   dscale[n] = S2[n],    dbias[n] = S1[n]           (f32; [N, C] affines, one
//            row per image: multi-style training, where the rows then add
//            into each style's parameters)
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
// Design: one cooperative launch per call, no atomics. The grid is at most
// the blocks the card holds at once (the occupancy API; the launch is
// refused otherwise), so a grid-wide barrier can join the two reductions.
// An image's pixels are cut into `G` chunks of `chunk` pixels (the wrapper's
// plan, ops/cuda/fused_instance_norm.py::bwd_plan); chunk t of image n is
// item n * G + t. All blocks but the last are workers: worker b takes items
// b, b + workers, ... (one item each at the training shapes). A thread owns
// four channels and one pixel lane of its block (NT / (C / 4) lanes).
//   1. Pass 1: each worker thread strides over its item's pixels, keeping
//      (S1, S2); the block adds its threads in a fixed tree and writes
//      part[n, t, 0..1, c].
//   2. cooperative_groups::this_grid().sync().
//   3. Each worker adds its image's G partials in the same fixed order (a
//      strided sum per thread, then the same tree), so every block of an
//      image holds the same S1, S2 bit for bit; meanwhile the last block
//      adds all N * G partials in one fixed order into dbias and dscale, so
//      no worker carries that tail. With [N, C] affines (affine_stride C:
//      image n reads its own row in load_chan) there is no sum over the
//      images: the block of chunk 0 of image n stores that image's S1, S2
//      as dbias[n], dscale[n], and the last block has nothing to add.
//   4. Pass 2 reads the item again backwards, the last-read lines first,
//      while L2 still holds them (marked first to evict), and writes dx with
//      streaming stores; 16-byte (f32) or 8-byte (bf16) accesses
//      (need_dx = false: no pass 2).
// x, the residual and g are read twice; the bound counts them once. The
// partials are G * 2 * C floats per image, read by each of its G blocks.
// At the training shapes a call's time is mostly its chain of dependent
// steps (launch, loads, barrier, partials, stores), not its bytes: the
// 64 x 64 x 128 calls (11 of 15 a step) take about 3.5x their bound.
// Keeping each thread's pixels in registers between the passes (one read)
// was slower there than this re-read from L2 (PERF.md §6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 512;

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

// The last read of a line: marked first to evict from L2 (__ldcs).
__device__ __forceinline__ float4 load4_last(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4_last(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// dx, which this kernel never reads again: streaming stores (__stcs).
__device__ __forceinline__ void store4_stream(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ void store4_stream(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// s = x (+ residual) at flat element offset off (four channels), in f32.
template <bool LAST, typename T>
__device__ __forceinline__ float4 load_sum(const T* __restrict__ x, const T* __restrict__ res,
                                           size_t off) {
  float4 v = LAST ? load4_last(x + off) : load4(x + off);
  if (res != nullptr) v = add4(v, LAST ? load4_last(res + off) : load4(res + off));
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

// Image n's statistics and affine for channels c..c+3: the affine row
// n * affine_stride (0: one [C] affine for all images; C: [N, C]).
__device__ __forceinline__ Chan4 load_chan(const float* mean, const float* inv,
                                           const float* scale, const float* bias,
                                           int affine_stride, int n, int C, int c) {
  Chan4 k;
  k.mu = load4(mean + (size_t)n * C + c);
  k.iv = load4(inv + (size_t)n * C + c);
  k.ga = load4(scale + (size_t)n * affine_stride + c);
  k.be = load4(bias + (size_t)n * affine_stride + c);
  return k;
}

// What the threads of a block share: each thread's channel group c4 (four
// channels) and pixel lane lp; ppi = NT / C4 lanes per channel group.
struct Lanes {
  int C4, ppi, c4, lp;
};

// Adds a (and b) over the ppi lanes of each channel group in a fixed tree
// (lane j takes lane j + stride, the stride halving); lane 0's sums are left
// in sh1[c4], sh2[c4]. Every thread of the block calls it.
__device__ __forceinline__ void block_sum(float4* sh1, float4* sh2, float4 a, float4 b,
                                          const Lanes& L) {
  const int tid = threadIdx.x;
  sh1[tid] = a;
  sh2[tid] = b;
  __syncthreads();
  int span = 1;
  while (span < L.ppi) span <<= 1;
  for (int stride = span >> 1; stride > 0; stride >>= 1) {
    if (L.lp < stride && L.lp + stride < L.ppi) {
      sh1[tid] = add4(sh1[tid], sh1[tid + stride * L.C4]);
      sh2[tid] = add4(sh2[tid], sh2[tid + stride * L.C4]);
    }
    __syncthreads();
  }
}

// S1, S2 of image n's four channels of this thread: its G chunk partials
// added in the same order by every block (lane lp takes chunks lp, lp +
// ppi, ..., then the tree), so all of the image's blocks agree bit for bit.
__device__ __forceinline__ void image_sums(const float* __restrict__ part, int n, int G, int C,
                                           float4* sh1, float4* sh2, const Lanes& L, float4& s1,
                                           float4& s2) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (L.lp < L.ppi) {
    for (int t = L.lp; t < G; t += L.ppi) {
      const float* p = part + ((size_t)n * G + t) * 2 * C + L.c4 * 4;
      a = add4(a, load4(p));
      b = add4(b, load4(p + C));
    }
  }
  block_sum(sh1, sh2, a, b, L);
  s1 = sh1[L.c4];
  s2 = sh2[L.c4];
  __syncthreads();  // sh1 and sh2 are written again by the next sum
}

// One element's dx from its sum s, gradient g and the image's S1, S2.
__device__ __forceinline__ float dx_of(float s, float mu, float iv, float ga, float be, float g,
                                       float a, float b, float rhw, int relu) {
  float xh, gm;
  xhat_gm(s, mu, iv, ga, be, g, relu, xh, gm);
  return iv * ga * (gm - a * rhw - xh * (b * rhw));
}

__device__ __forceinline__ float4 dx4(float4 s, float4 gg, const Chan4& k, float4 a, float4 b,
                                      float rhw, int relu) {
  return make_float4(dx_of(s.x, k.mu.x, k.iv.x, k.ga.x, k.be.x, gg.x, a.x, b.x, rhw, relu),
                     dx_of(s.y, k.mu.y, k.iv.y, k.ga.y, k.be.y, gg.y, a.y, b.y, rhw, relu),
                     dx_of(s.z, k.mu.z, k.iv.z, k.ga.z, k.be.z, gg.z, a.z, b.z, rhw, relu),
                     dx_of(s.w, k.mu.w, k.iv.w, k.ga.w, k.be.w, gg.w, a.w, b.w, rhw, relu));
}

// Adds one element group's (S1, S2) terms into s1, s2.
__device__ __forceinline__ void add_terms(float4 s, float4 gg, const Chan4& k, int relu,
                                          float4& s1, float4& s2) {
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

template <typename T>
__global__ void __launch_bounds__(NT, 2)
inb_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ g,
           const float* __restrict__ mean, const float* __restrict__ inv,
           const float* __restrict__ scale, const float* __restrict__ bias,
           int affine_stride, int N, int HW, int C, int relu, int G, int chunk,
           float* __restrict__ part,
           float* __restrict__ dscale, float* __restrict__ dbias, T* __restrict__ dx) {
  __shared__ float4 sh1[NT];
  __shared__ float4 sh2[NT];
  Lanes L;
  L.C4 = C / 4;
  L.ppi = NT / L.C4;
  L.c4 = threadIdx.x % L.C4;
  L.lp = threadIdx.x / L.C4;
  const bool lane = L.lp < L.ppi;  // threads past ppi * C4 own no pixels
  const int c = L.c4 * 4;
  const int items = N * G;
  const int workers = gridDim.x - 1;  // the last block adds dscale and dbias

  // Pass 1: the chunk partials of each item of this block.
  for (int item = blockIdx.x; blockIdx.x < workers && item < items; item += workers) {
    const int n = item / G, t = item - n * G;
    const int pb = t * chunk, pe = min(HW, pb + chunk);
    float4 s1 = make_float4(0.f, 0.f, 0.f, 0.f), s2 = s1;
    if (lane) {
      const Chan4 k = load_chan(mean, inv, scale, bias, affine_stride, n, C, c);
#pragma unroll 4
      for (int p = pb + L.lp; p < pe; p += L.ppi) {
        const size_t off = ((size_t)n * HW + p) * C + c;
        add_terms(load_sum<false>(x, res, off), load4(g + off), k, relu, s1, s2);
      }
    }
    block_sum(sh1, sh2, s1, s2, L);
    if (threadIdx.x < L.C4) {
      float* o = part + (size_t)item * 2 * C + c;
      *reinterpret_cast<float4*>(o) = sh1[threadIdx.x];
      *reinterpret_cast<float4*>(o + C) = sh2[threadIdx.x];
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  const bool per_image = affine_stride != 0;
  if (blockIdx.x == workers) {
    // dscale and dbias of a [C] affine: all N * G partials in one fixed
    // order, while the other blocks write dx.
    if (per_image) return;
    float4 db, ds;
    image_sums(part, 0, items, C, sh1, sh2, L, db, ds);
    if (threadIdx.x < L.C4) {
      *reinterpret_cast<float4*>(dscale + c) = ds;
      *reinterpret_cast<float4*>(dbias + c) = db;
    }
    return;
  }
  if (dx == nullptr && !per_image) return;

  // Pass 2: dx of each item from the image's sums, the item read again
  // backwards: the lines read last in pass 1 first, while L2 holds them.
  // With [N, C] affines the block of an image's chunk 0 also stores the
  // image's sums as its row of dbias and dscale.
  const float rhw = 1.f / (float)HW;
  for (int item = blockIdx.x; item < items; item += workers) {
    const int n = item / G, t = item - n * G;
    if (dx == nullptr && t != 0) continue;  // the same for the whole block
    float4 a, b;
    image_sums(part, n, G, C, sh1, sh2, L, a, b);
    if (per_image && t == 0 && threadIdx.x < L.C4) {
      *reinterpret_cast<float4*>(dscale + (size_t)n * C + c) = b;
      *reinterpret_cast<float4*>(dbias + (size_t)n * C + c) = a;
    }
    if (dx == nullptr) continue;
    const int pb = t * chunk, pe = min(HW, pb + chunk);
    if (!lane || pb + L.lp >= pe) continue;
    const Chan4 k = load_chan(mean, inv, scale, bias, affine_stride, n, C, c);
    const int last = pb + L.lp + (pe - 1 - pb - L.lp) / L.ppi * L.ppi;
#pragma unroll 4
    for (int p = last; p >= pb; p -= L.ppi) {
      const size_t off = ((size_t)n * HW + p) * C + c;
      store4_stream(dx + off,
                    dx4(load_sum<true>(x, res, off), load4_last(g + off), k, a, b, rhw, relu));
    }
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* g, const void* mean, const void* inv,
           const void* scale, const void* bias, int affine_stride, void* part, void* dscale,
           void* dbias, void* dx, int N, int HW, int C, int relu, int grid, int G, int chunk,
           void* stream) {
  // Four channels a thread, at least one pixel lane per channel group; a
  // chunk plan that covers every pixel of every image; a worker block and
  // the sums block.
  if (N < 1 || HW < 1 || C % 4 != 0 || C < 4 || C / 4 > NT || grid < 2 || G < 1 || chunk < 1 ||
      (long long)G * chunk < HW || (long long)(G - 1) * chunk >= HW ||
      (affine_stride != 0 && affine_stride != C))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const T* gt = static_cast<const T*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float* dsp = static_cast<float*>(dscale);
  float* dbp = static_cast<float*>(dbias);
  T* dxp = static_cast<T*>(dx);
  void* args[] = {&xt, &rt, &gt, &mp, &ip, &sp, &bp, &affine_stride, &N, &HW, &C,
                  &relu, &G, &chunk, &pp, &dsp, &dbp, &dxp};
  // Refused (cudaErrorCooperativeLaunchTooLarge) when the grid exceeds the
  // blocks the device holds at once.
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(inb_kernel<T>),
                                                dim3(grid), dim3(NT), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of inb_kernel<T> the current device holds at once.
template <typename T>
int resident(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inb_kernel<T>, NT, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* stx_instance_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, g, dx [N, H, W, C] (HW = H * W); res the same or NULL; mean/inv [N, C]
// f32 from the forward; scale/bias f32, [C] (affine_stride 0) or [N, C]
// (affine_stride C); part [N, G, 2, C] f32 scratch for G chunks of `chunk`
// pixels per image (G * chunk >= HW > (G - 1) * chunk); dscale/dbias f32
// outputs shaped as scale. dx NULL skips pass 2. C % 4 == 0, C <= 2048;
// `grid` (the chunks' blocks and the sums block) at most the blocks that
// stx_in_bwd_resident_f32 reports.
int stx_in_bwd_f32(const void* x, const void* res, const void* g, const void* mean,
                   const void* inv, const void* scale, const void* bias, int affine_stride,
                   void* part, void* dscale, void* dbias, void* dx, int N, int HW, int C,
                   int relu, int grid, int G, int chunk, void* stream) {
  return launch<float>(x, res, g, mean, inv, scale, bias, affine_stride, part, dscale, dbias,
                       dx, N, HW, C, relu, grid, G, chunk, stream);
}

// As stx_in_bwd_f32 with x, res, g and dx in bf16.
int stx_in_bwd_bf16(const void* x, const void* res, const void* g, const void* mean,
                    const void* inv, const void* scale, const void* bias, int affine_stride,
                    void* part, void* dscale, void* dbias, void* dx, int N, int HW, int C,
                    int relu, int grid, int G, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, res, g, mean, inv, scale, bias, affine_stride, part, dscale,
                               dbias, dx, N, HW, C, relu, grid, G, chunk, stream);
}

// The blocks of each dtype's kernel that the current device holds at once:
// the largest grid a launch may have.
int stx_in_bwd_resident_f32(int* blocks) { return resident<float>(blocks); }
int stx_in_bwd_resident_bf16(int* blocks) { return resident<__nv_bfloat16>(blocks); }

}  // extern "C"
