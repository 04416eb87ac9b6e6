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
// The same kernel at pad 0 with res_f32 == 1 is the forward of
// fused_instance_norm (_pallas_forward -> _kernel / _kernel_with_res) for the
// training forward: mean and inv go back to the caller, which keeps them for
// the backward (csrc/instance_norm_bwd.cu). One forward serves both paths.
// With no statistics given, var is the exact centered variance, as in the
// TPU kernel; with (sums, sumsqs) it is the one-pass form clamped at 0, as
// in styletransfer_tpu/ops/layers.py instance_norm_stats.
//
// What bounds it on an H100: bytes. It does a few operations per element,
// far below the ~20 FLOP/byte (f32) where the card stops being bound by
// memory. The largest call of the forward ([64, 256, 256, 32] -> pad 1) moves
// 537 MB in and 545 MB out in f32.
//
// Design: one launch per call, one image per thread-block cluster. The TPU
// kernel held one whole image in VMEM per grid step: one HBM read and one
// padded write per sample. Here the `ctas` blocks of one image (a cluster of
// up to 16, launched with cudaLaunchKernelEx) each own a band of `rows`
// whole image rows, and each writes the output rows its band feeds,
// including the reflected or edge border rows and columns at the image's
// top and bottom. ops/cuda/instance_norm.py::in_plan names the route:
//   ROUTE_L2: every image without given statistics. Each thread keeps
//     (n, mean, M2) over its pixels, merging one group of U pixels at a
//     time with Chan's formula (one reciprocal per group, not per element);
//     the block merges its threads, the cluster its blocks in rank order
//     over distributed shared memory (DSMEM, the remote partials gathered
//     in one round trip); then each block reads its band again, backwards
//     (the rows read last come back first, while L2 still holds them),
//     marking those lines first to evict. A round of resident clusters
//     keeps 57 MB (bf16 in1) to 115 MB (f32) of bands live against a 50 MB
//     L2, so part of the re-read still comes from HBM: the route runs at
//     just over half its bound. Keeping a band in shared memory instead
//     (one HBM read, as on the TPU) was, on an H100, 1.6-5% faster where
//     two blocks fit an SM (bf16 bands of 4-5 rows of 64-75 x 128), 7-10%
//     slower at the training forward's batch of 4, and slower where only
//     one block fits, so the kernel has no such route.
//   ROUTE_SUMS: (sums, sumsqs) come from the conv3x3 kernel: no reduction,
//     no cluster; about one wave of blocks normalizes x.
// Per element: 16-byte loads and stores (8-byte for bf16 where C % 8 != 0),
// neighbouring threads on neighbouring channels, U = 8 raw vectors in flight
// per thread, streaming stores (the output is not read again here); each
// thread keeps one channel group, so the statistics and affine are read
// once into registers; pixels are walked by row and column with no division
// per element. Every merge runs in a fixed order with no atomics: a call
// repeats bit for bit.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;  // threads per block
constexpr int U = 8;     // raw vectors in flight per thread
constexpr int ROUTE_SUMS = 0, ROUTE_L2 = 1;
constexpr int MAX_CLUSTER = 16;

// VEC consecutive values of T: the raw vector (16 or 8 bytes) and its floats;
// ld_last / st_stream mark the lines first to evict from L2 (__ldcs, __stcs):
// a last read of the input, and the output, which this kernel never reads.
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw ld(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ Raw ld_last(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st_stream(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
__device__ __forceinline__ void unpack(uint32_t u, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw ld(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float (&v)[8]) {
    unpack(r.x, v[0], v[1]);
    unpack(r.y, v[2], v[3]);
    unpack(r.z, v[4], v[5]);
    unpack(r.w, v[6], v[7]);
  }
  static __device__ __forceinline__ Raw ld_last(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void st_stream(__nv_bfloat16* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7])));
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw ld(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float (&v)[4]) {
    unpack(r.x, v[0], v[1]);
    unpack(r.y, v[2], v[3]);
  }
  static __device__ __forceinline__ Raw ld_last(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void st_stream(__nv_bfloat16* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(pack(v[0], v[1]), pack(v[2], v[3])));
  }
};

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Params {
  const void* x;    // [N, H, W, C]
  const void* res;  // [N, H + 2 rp, W + 2 rp, C] or NULL
  const float *sums, *sumsqs;  // [N, C] or NULL
  const float *scale, *bias;   // [C]
  void* out;                   // [N, H + 2 pad, W + 2 pad, C]
  float *mean, *inv;           // [N, C]
  int H, W, C, rp, res_f32, pad, edge, relu;
  float eps;
  int rows;  // image rows per block
  int ctas;  // blocks per image
};

// One step of a thread's pixel walk: the pixel `step = dy * w + dx` further
// on, in a row of w pixels (dx < w).
__device__ __forceinline__ void advance(int& y, int& x, int dy, int dx, int w) {
  y += dy;
  x += dx;
  if (x >= w) {
    x -= w;
    ++y;
  }
}

// The same walk backwards.
__device__ __forceinline__ void retreat(int& y, int& x, int dy, int dx, int w) {
  y -= dy;
  x -= dx;
  if (x < 0) {
    x += w;
    --y;
  }
}

__device__ __forceinline__ int source_index(int i, int L, int edge) {
  if (edge) return min(max(i, 0), L - 1);
  if (i < 0) return -i;
  if (i >= L) return 2 * (L - 1) - i;
  return i;
}

// The fixed-order tree over the PL pixel lanes of one channel group: slot t
// (= pl * CV + cv) holds WIDTH floats; merge(a, b) folds slot b into slot a.
// Afterwards slot cv holds the group's total.
template <int WIDTH, typename Merge>
__device__ __forceinline__ void block_tree(float* scratch, int t, int pl, int PL, int CV,
                                           Merge merge) {
  int half = 1;
  while (half < PL) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    __syncthreads();
    if (pl < half && pl + half < PL) merge(scratch + t * WIDTH, scratch + (t + half * CV) * WIDTH);
  }
  __syncthreads();
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a), VEC channels at once.
template <int VEC>
__device__ __forceinline__ void chan_merge(float* a, const float* b) {
  const float na = a[0], nb = b[0];
  if (nb == 0.f) return;
  const float n = na + nb, f = nb / n;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float d = b[1 + j] - a[1 + j];
    a[1 + j] += d * f;
    a[1 + VEC + j] += b[1 + VEC + j] + d * d * na * f;
  }
  a[0] = n;
}

// Dynamic shared memory: mean, inv * scale and the cluster partials [4][C],
// and on ROUTE_L2 each thread's (n, mean[VEC], M2[VEC]).
template <int VEC, int ROUTE>
size_t smem_bytes(const Params& p) {
  return (size_t)4 * p.C * 4 + (ROUTE == ROUTE_L2 ? (size_t)NT * (1 + 2 * VEC) * 4 : 0);
}

// The partials of channel i of every block of the cluster, loaded all at
// once (one DSMEM round trip, not one per rank); ranks past the cluster
// read as 0.
__device__ __forceinline__ void gather(cg::cluster_group& cluster, float* part, int i,
                                       int ranks, float (&got)[MAX_CLUSTER]) {
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    got[r] = r < ranks ? cluster.map_shared_rank(part, r)[i] : 0.f;
}

// grid N * ctas blocks, block n * ctas + k owns image rows [k * rows,
// (k + 1) * rows) of image n; clusters of ctas blocks (1 on ROUTE_SUMS).
// T: the tensors' type; RES: a residual is added.
template <typename T, int VEC, int ROUTE, bool RES>
__global__ void __launch_bounds__(NT, 2) in_kernel(const Params p) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, C = p.C;
  const int CV = C / VEC, PL = NT / CV;  // channel groups; pixel lanes
  const int t = threadIdx.x, cv = t % CV, pl = t / CV, c = cv * VEC;
  const bool active = pl < PL;
  const int n = blockIdx.x / p.ctas, k = blockIdx.x - n * p.ctas;
  const int r0 = min(H, k * p.rows), r1 = min(H, r0 + p.rows);
  const int P = (r1 - r0) * W;  // pixels of the band
  const float HW = (float)H * (float)W;
  const int Wr = W + 2 * p.rp;
  float* mu = reinterpret_cast<float*>(smem);  // [C] mean
  float* mul = mu + C;                          // [C] inv * scale
  float* part = mul + C;                        // [2][C] the block's partials
  float* scratch = part + 2 * C;                // [NT][1 + 2 * VEC] on ROUTE_L2
  const T* x = static_cast<const T*>(p.x) + (size_t)n * H * W * C;
  const T* res = RES ? static_cast<const T*>(p.res) + (size_t)n * (H + 2 * p.rp) * Wr * C
                     : nullptr;
  const int dy = PL / W, dx = PL - dy * W;  // a thread's step over the band
  // s at pixel (y, xx) of the image from the raw vectors of x and residual.
  auto s_of = [&](const Raw& rx, const Raw& rr, float(&v)[VEC]) {
    V::to_float(rx, v);
    if constexpr (RES) {
      float r[VEC];
      V::to_float(rr, r);
      const T* tag = nullptr;
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = p.res_f32 ? v[j] + r[j] : round_to(v[j] + r[j], tag);
    }
  };
  auto x_at = [&](int y, int xx) { return V::ld(x + (y * W + xx) * C + c); };
  auto r_at = [&](int y, int xx) {
    Raw r{};
    if constexpr (RES) r = V::ld(res + ((y + p.rp) * Wr + xx + p.rp) * C + c);
    return r;
  };

  if constexpr (ROUTE == ROUTE_SUMS) {
    for (int i = t; i < C; i += NT) {
      const float m = p.sums[n * C + i] / HW;
      const float var = fmaxf(p.sumsqs[n * C + i] / HW - m * m, 0.f);
      const float iv = 1.f / sqrtf(var + p.eps);
      mu[i] = m;
      mul[i] = iv * p.scale[i];
      if (k == 0) {
        p.mean[n * C + i] = m;
        p.inv[n * C + i] = iv;
      }
    }
    __syncthreads();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    // (n, mean, M2) per thread, one group of U pixels at a time.
    float cnt = 0.f, m[VEC] = {}, q2[VEC] = {};
    if (active) {
      int y = r0 + pl / W, xx = pl % W, q = pl;
      for (; q + (U - 1) * PL < P; q += U * PL) {
        Raw rx[U], rr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          rx[u] = x_at(y, xx);
          rr[u] = r_at(y, xx);
          advance(y, xx, dy, dx, W);
        }
        float gm[VEC] = {}, gq[VEC] = {};
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float v[VEC];
          s_of(rx[u], rr[u], v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) gm[j] += v[j];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) gm[j] *= 1.f / U;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float v[VEC];
          s_of(rx[u], rr[u], v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float e = v[j] - gm[j];
            gq[j] += e * e;
          }
        }
        const float f = (float)U / (cnt + (float)U);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = gm[j] - m[j];
          m[j] += d * f;
          q2[j] += gq[j] + d * d * cnt * f;
        }
        cnt += (float)U;
      }
      for (; q < P; q += PL) {
        float v[VEC];
        s_of(x_at(y, xx), r_at(y, xx), v);
        advance(y, xx, dy, dx, W);
        cnt += 1.f;
        const float f = 1.f / cnt;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[j] - m[j];
          m[j] += d * f;
          q2[j] += d * (v[j] - m[j]);
        }
      }
    }
    float* slot = scratch + t * (1 + 2 * VEC);
    slot[0] = cnt;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      slot[1 + j] = m[j];
      slot[1 + VEC + j] = q2[j];
    }
    block_tree<1 + 2 * VEC>(scratch, t, pl, PL, CV,
                            [](float* a, const float* b) { chan_merge<VEC>(a, b); });
    if (t < CV)
      for (int j = 0; j < VEC; ++j) {
        part[c + j] = slot[1 + j];
        part[C + c + j] = slot[1 + VEC + j];
      }
    cluster.sync();
    for (int i = t; i < C; i += NT) {
      float gm[MAX_CLUSTER], gq[MAX_CLUSTER];
      gather(cluster, part, i, p.ctas, gm);
      gather(cluster, part + C, i, p.ctas, gq);
      float a[3] = {0.f, 0.f, 0.f};  // (n, mean, M2) merged over the ranks in order
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        const int b0 = min(H, r * p.rows), b1 = min(H, b0 + p.rows);
        const float b[3] = {r < p.ctas ? (float)((b1 - b0) * W) : 0.f, gm[r], gq[r]};
        chan_merge<1>(a, b);
      }
      const float iv = 1.f / sqrtf(a[2] / a[0] + p.eps);
      mu[i] = a[1];
      mul[i] = iv * p.scale[i];
      if (k == 0) {
        p.mean[n * C + i] = a[1];
        p.inv[n * C + i] = iv;
      }
    }
    // Every block has read the partials (and mu, mul are in place).
    cluster.sync();
  }

  // Normalize and write the output rows the band feeds.
  if (P > 0 && active) {
    float m[VEC], sc[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = mu[c + j];
      sc[j] = mul[c + j];
      b[j] = p.bias[c + j];
    }
    const int pad = p.pad, Wo = W + 2 * pad, Ho = H + 2 * pad;
    const int o0 = r0 == 0 ? 0 : r0 + pad, o1 = r1 == H ? Ho : r1 + pad;
    const int Q = (o1 - o0) * Wo;
    T* out = static_cast<T*>(p.out) + ((size_t)n * Ho + o0) * Wo * C + c;
    const int ody = PL / Wo, odx = PL - ody * Wo;
    auto emit = [&](T* dst, float(&v)[VEC]) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float o = (v[j] - m[j]) * sc[j] + b[j];
        v[j] = p.relu ? fmaxf(o, 0.f) : o;
      }
      V::st_stream(dst, v);
    };
    // Backwards from the band's last output pixel: on the L2 route the rows
    // read last by the statistics come back first, while L2 still holds
    // them. Output pixel Q - 1 - q for q = pl, pl + PL, ...
    int oy = o0 + (Q - 1 - pl) / Wo, ox = (Q - 1 - pl) % Wo, q = pl;
    auto x_last = [&](int y, int xx) {
      return ROUTE == ROUTE_L2 ? V::ld_last(x + (y * W + xx) * C + c) : x_at(y, xx);
    };
    for (; q + (U - 1) * PL < Q; q += U * PL) {
      Raw rx[U], rr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int sy = source_index(oy - pad, H, p.edge);
        const int sx = source_index(ox - pad, W, p.edge);
        retreat(oy, ox, ody, odx, Wo);
        rx[u] = x_last(sy, sx);
        rr[u] = r_at(sy, sx);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float v[VEC];
        s_of(rx[u], rr[u], v);
        emit(out + (size_t)(Q - 1 - (q + u * PL)) * C, v);
      }
    }
    for (; q < Q; q += PL) {
      const int sy = source_index(oy - pad, H, p.edge), sx = source_index(ox - pad, W, p.edge);
      retreat(oy, ox, ody, odx, Wo);
      float v[VEC];
      s_of(x_last(sy, sx), r_at(sy, sx), v);
      emit(out + (size_t)(Q - 1 - q) * C, v);
    }
  }
}

// Launches the kernel, or with `clusters` set reports how many of its
// clusters the device runs at once instead.
template <typename T, int VEC, int ROUTE, bool RES>
cudaError_t run(const Params& p, int N, int cluster, cudaStream_t stream, int* clusters) {
  static hopper::Granted granted;
  auto kernel = in_kernel<T, VEC, ROUTE, RES>;
  const size_t smem = smem_bytes<VEC, ROUTE>(p);  // at most 33 KB: no opt-in
  cudaError_t err;
  if (cluster > 8 && (err = hopper::allow_large_clusters(kernel, &granted)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * p.ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, p)) != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC, bool RES>
cudaError_t by_route(int route, const Params& p, int N, int cluster, cudaStream_t stream,
                     int* clusters) {
  if (route == ROUTE_SUMS) return run<T, VEC, ROUTE_SUMS, RES>(p, N, cluster, stream, clusters);
  return run<T, VEC, ROUTE_L2, RES>(p, N, cluster, stream, clusters);
}

template <typename T, int VEC>
cudaError_t by_residual(int route, const Params& p, int N, int cluster, cudaStream_t stream,
                        int* clusters) {
  if (p.res != nullptr) return by_route<T, VEC, true>(route, p, N, cluster, stream, clusters);
  return by_route<T, VEC, false>(route, p, N, cluster, stream, clusters);
}

template <typename T>
int launch(const void* x, const void* res, int res_pad, int res_f32, const void* sums,
           const void* sumsqs, const void* scale, const void* bias, void* out, void* mean,
           void* inv, int N, int H, int W, int C, int pad, int edge, int relu, float eps,
           int route, int ctas, int cluster, int rows, int vec, void* stream, int* clusters) {
  Params p;
  p.x = x;
  p.res = res;
  p.sums = static_cast<const float*>(sums);
  p.sumsqs = static_cast<const float*>(sumsqs);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.mean = static_cast<float*>(mean);
  p.inv = static_cast<float*>(inv);
  p.H = H;
  p.W = W;
  p.C = C;
  p.rp = res_pad;
  p.res_f32 = res_f32;
  p.pad = pad;
  p.edge = edge;
  p.relu = relu;
  p.eps = eps;
  p.rows = rows;
  p.ctas = ctas;
  const uintptr_t align = (uintptr_t)vec * sizeof(T) - 1;
  const bool given = sums != nullptr && sumsqs != nullptr;
  // The plan's shape: every image row in one block's band, a cluster of the
  // image's blocks (one block on ROUTE_SUMS), whole channel groups.
  if (N < 1 || H < 1 || W < 1 || C < 4 || C > 1024 || C % vec != 0 || C / vec > NT ||
      rows < 1 || ctas < 1 || (long)rows * ctas < H || (route == ROUTE_SUMS) != given ||
      route < ROUTE_SUMS || route > ROUTE_L2 || cluster != (route == ROUTE_SUMS ? 1 : ctas) ||
      cluster > MAX_CLUSTER || (!edge && pad >= (H < W ? H : W)) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
        reinterpret_cast<uintptr_t>(out)) & align) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) err = by_residual<float, 4>(route, p, N, cluster, st, clusters);
  } else {
    if (vec == 8) err = by_residual<T, 8>(route, p, N, cluster, st, clusters);
    if (vec == 4) err = by_residual<T, 4>(route, p, N, cluster, st, clusters);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* stx_instance_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [N, H, W, C]; res [N, H+2*res_pad, W+2*res_pad, C] or NULL, its interior
// added in f32 (res_f32 = 1) or rounded to x's type (res_f32 = 0); sums/sumsqs
// [N, C] f32 or NULL; scale/bias [C] f32; mean/inv [N, C] f32 outputs; out
// [N, H+2*pad, W+2*pad, C]. The plan (ops/cuda/instance_norm.py::in_plan):
// route (0 given sums, 1 band re-read from L2),
// ctas blocks of `rows` image rows per image in clusters of `cluster`
// blocks, `vec` channels per access. With `clusters` non-NULL nothing is
// launched: it receives how many such clusters the device runs at once.
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for a shape or
// plan the kernel does not take).
int stx_in_pad_f32(const void* x, const void* res, int res_pad, int res_f32, const void* sums,
                   const void* sumsqs, const void* scale, const void* bias, void* out, void* mean,
                   void* inv, int N, int H, int W, int C, int pad, int edge, int relu, float eps,
                   int route, int ctas, int cluster, int rows, int vec, void* stream,
                   int* clusters) {
  return launch<float>(x, res, res_pad, res_f32, sums, sumsqs, scale, bias, out, mean, inv, N, H,
                       W, C, pad, edge, relu, eps, route, ctas, cluster, rows, vec, stream,
                       clusters);
}

// As stx_in_pad_f32 with x, res and out in bf16.
int stx_in_pad_bf16(const void* x, const void* res, int res_pad, int res_f32, const void* sums,
                    const void* sumsqs, const void* scale, const void* bias, void* out,
                    void* mean, void* inv, int N, int H, int W, int C, int pad, int edge,
                    int relu, float eps, int route, int ctas, int cluster, int rows, int vec,
                    void* stream, int* clusters) {
  return launch<__nv_bfloat16>(x, res, res_pad, res_f32, sums, sumsqs, scale, bias, out, mean,
                               inv, N, H, W, C, pad, edge, relu, eps, route, ctas, cluster, rows,
                               vec, stream, clusters);
}

}  // extern "C"
