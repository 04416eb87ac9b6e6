// 3x3 VALID convolution + bias (+ReLU) with per-image instance-norm sums,
// bf16 on Hopper's tensor cores.
//
// Replaces, in bf16, the TPU kernel styletransfer_tpu/ops/pallas/conv3x3.py
// (conv3x3_valid -> _call -> _kernel): out[b, y, x, o] =
//   sum_{dy,dx,c} xpad[b, y+dy, x+dx, c] * w[dy, dx, c, o] + bias[o]
// on an input that the previous instance norm already wrote padded, plus
// sums[b, o] and sumsqs[b, o] of the post-activation f32 accumulator (taken
// before the one rounding to bf16), ready for the next instance norm. It
// serves bf16 at every width up to 256 (ops/cuda/conv3x3.py::valid_plan);
// conv3x3.cu's mma.sync kernel serves wider rows.
//
// What bounds it on an H100: the residual-stack call ([64, 66, 66, 128] ->
// [64, 64, 64, 128]) is 77.3 GFLOP on 139 MB, bound by the tensor cores
// (0.078 ms at 989 TFLOP/s). Every tap's window is read again from L2 (the
// A operand of one k-step is one tap's shifted window), so the bytes from
// L2 to the SMs are about 9x the input and the weights are read once per
// tile: the larger the tile, the fewer of those bytes. The loads alone and
// the math alone each take most of the kernel's time
// (scripts/torch_wgmma_ablation.py times both).
//
// Design: an implicit GEMM over [B*H*W] x [9*C] -> [O] whose K axis is the
// nine taps times the 64-channel chunks of C (18 k-steps at C = 128). A tile
// is rows = floor(BM / W) whole output rows of one image, rows x W <= BM
// output positions, by BN = 128 output channels.
//   A: one TMA box of a 4-D map over x [B, Hp, Wp, C] per k-step: box
//      {64 channels, W, rows, 1 image} at (c0, dx, y0 + dy, b) is the tap's
//      (rows x W) x 64 window, and it lands K-major in the 128-byte swizzle
//      that a wgmma descriptor reads (no ldmatrix, no garbage columns). Where
//      rows x W < BM (75 wide: 225 of 256), the stage's last A rows keep
//      whatever an earlier box left there. Row i of a wgmma's D reads only
//      row i of A, so they reach only accumulator rows that are neither
//      stored nor summed.
//   B: the tap's 64 x BN weights by TMA, from a 3-D map over w as [9, C, O],
//      N-major in the same swizzle (64-channel atoms of 64 k-rows).
//   A ring of STAGES stages, each with a "full" mbarrier that counts the
//   bytes in and an "empty" one that counts the consumer warps out. One
//   thread of a producer warpgroup issues the boxes; two consumer
//   warpgroups each issue wgmma m64n128k16 from shared memory on BM / 2
//   rows, keep one k-step's group in flight, and free a stage once its group
//   has retired. setmaxnreg moves registers from the producer to the
//   consumers (232 a thread: 128 accumulators at BM = 256, no spills). The
//   grid is persistent (one block per SM), so the producer fills the ring
//   for the next tile while the consumers run this tile's epilogue.
//   Epilogue: bias in f32, ReLU and one rounding to bf16 into a staging
//   tile in shared memory (one [BM][64] box per 64 channels), stored by TMA
//   as {64, W, rows, 1} boxes of a 4-D map over out, whole rows only, while
//   the next tile computes; the
//   per-tile column sums and sums of squares of the f32 values, added in a
//   fixed order (each thread's rows, a butterfly over the lanes, then the
//   eight consumer warps in order) and written per tile; tile_sums_kernel
//   then adds each image's tiles in tile order. No atomics: a call is the
//   same bit for bit from run to run.
// TMA fills what lies outside x or w with zeros: a last chunk of C that is
// not full, rows below the image, weights past O. The TMA stores drop rows
// below the image and channels past O, and the sums skip them.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 128;                    // output channels per tile
constexpr int BK = 64;                     // channels per k-step: one 128-byte swizzle row
constexpr int CONSUMER_WARPS = 8;          // two warpgroups of wgmma
constexpr int NT = CONSUMER_WARPS * 32 + 128;  // + one producer warpgroup
constexpr int B_BOX_BYTES = 64 * BK * 2;   // one 64-channel atom of the weights
constexpr int B_BYTES = BN / 64 * B_BOX_BYTES;
constexpr int RED_BYTES = 2 * CONSUMER_WARPS * BN * 4;  // the epilogue's per-warp sums

struct Shape {
  int H, W, O;
  int rows;       // output rows per tile: floor(BM / W)
  int row_tiles;  // tiles per image along the rows
  int n_tiles;    // tiles along the output channels
  int tiles;      // B * row_tiles * n_tiles
  int chunks;     // 64-channel chunks of C
};

struct Tile {
  int img, mt, y0, n0;
};

__device__ __forceinline__ Tile tile_of(int t, const Shape& s) {
  const int r = t / s.n_tiles;
  Tile tile;
  tile.n0 = (t - r * s.n_tiles) * BN;
  tile.img = r / s.row_tiles;
  tile.mt = r - tile.img * s.row_tiles;
  tile.y0 = tile.mt * s.rows;
  return tile;
}

template <int BM>
__host__ __device__ constexpr int stage_bytes() {
  return BM * BK * 2 + B_BYTES;
}

template <int BM, int STAGES>
constexpr size_t smem_bytes() {
  // The ring, the bf16 output tile, the per-warp sums, and the alignment.
  return (size_t)STAGES * stage_bytes<BM>() + BM * BN * 2 + RED_BYTES + 1024;
}

template <int BM, int STAGES>
__global__ void __launch_bounds__(NT, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap to, const float* __restrict__ bias,
                     float* __restrict__ psum, float* __restrict__ psq, Shape s, int relu) {
  constexpr int MI = BM / 128;  // m64 blocks of rows per consumer warpgroup
  constexpr int A_BYTES = BM * BK * 2;  // the A slot of a stage; a box fills rows * W of its rows
  constexpr int STAGE = stage_bytes<BM>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  // Swizzled layouts repeat every 1024 bytes: align the stages to that.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // After the ring: the output tile as BN / 64 [BM][64] bf16 boxes in the
  // 128-byte swizzle; then the per-warp sums [2][warp][BN].
  unsigned char* staging = smem + STAGES * STAGE;
  float* red = reinterpret_cast<float*>(staging + BM * BN * 2);
  const int tid = threadIdx.x;
  const int ksteps = 9 * s.chunks;
  const int positions = s.rows * s.W;  // output positions of a tile

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER_WARPS * 32) {
    // The producer warpgroup gives its registers to the consumers, and one
    // of its threads issues every box. k-step k of a tile reads tap k % 9 of
    // channel chunk k / 9 (the nine taps of a chunk in a row read
    // overlapping windows, which L2 then holds).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMER_WARPS * 32) {
      int it = 0;
      for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
        const Tile tile = tile_of(t, s);
        const int boxes = min(BN / 64, (s.O - tile.n0 + 63) / 64);  // atoms inside w
        for (int k = 0; k < ksteps; ++k, ++it) {
          const int stage = it % STAGES;
          mbar_wait(empty + stage, ((it / STAGES) & 1) ^ 1);
          const int tap = k % 9, c0 = k / 9 * BK;
          unsigned char* a = smem + stage * STAGE;
          mbar_expect(full + stage, positions * BK * 2 + boxes * B_BOX_BYTES);
          tma_4d(a, &tx, c0, tap % 3, tile.y0 + tap / 3, tile.img, full + stage);
          for (int h = 0; h < boxes; ++h)
            tma_3d(a + A_BYTES + h * B_BOX_BYTES, &tw, tile.n0 + h * 64, c0, tap, full + stage);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows [wg * BM / 2, (wg + 1) * BM / 2)
  // of the tile, as MI m64 blocks (2 x 64 accumulators a thread at BM = 256).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[MI][64];
  int it = 0;
  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tile = tile_of(t, s);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int stage = it % STAGES;
      mbar_wait(full + stage, (it / STAGES) & 1);
      const unsigned char* a = smem + stage * STAGE + wg * MI * 64 * BK * 2;
      const unsigned char* b = smem + stage * STAGE + A_BYTES;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[mi][i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // B: 16 k-rows of 128 bytes per k16; 8-row groups 1024 bytes apart
        // (stride byte offset), 64-channel atoms B_BOX_BYTES apart (leading).
        const uint64_t db = smem_desc(b + kk * 16 * 128, B_BOX_BYTES, 1024, true);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          // A, K-major: 32 bytes per k16 along the 128-byte row, 8-row
          // groups 1024 bytes apart.
          wgmma_m64n128k16_ss(acc[mi], smem_desc(a + mi * 64 * 128 + kk * 32, 16, 1024, true),
                              db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // The previous k-step's group has retired: free its stage.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[mi][i]);
      if (k > 0 && lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[mi][i]);
    if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);

    // Epilogue. Accumulator of n8 tile i: e = 0,1 -> row g, channels
    // 8i + 2*t4 + {0,1}; e = 2,3 -> row g + 8. Each warpgroup rounds its rows
    // into the staging tile, where channel group i (16 bytes) of tile row R
    // sits at chunk (i % 8) ^ (R % 8) of box i / 8, and one thread stores the
    // boxes by TMA: the tile's rows x W positions, whole image rows (rows
    // below the image and channels past O are not written). The store runs
    // on while the next tile computes; before the staging tile is written
    // again, its reads have finished.
    constexpr int BOX = BM * 128;  // bytes of one [BM][64] box
    const int first = tile.y0 * s.W;  // the tile's first position in the image
    if (tid == 0) bulk_wait_read<0>();
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = tile.n0 + i * 8 + t4 * 2;
      const float b0 = n < s.O ? bias[n] : 0.f, b1 = n + 1 < s.O ? bias[n + 1] : 0.f;
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * (BM / 2) + mi * 64 + (warp & 3) * 16 + g + 8 * h;
          const float v0 = conv3x3::bias_relu(acc[mi][i * 4 + h * 2], b0, relu);
          const float v1 = conv3x3::bias_relu(acc[mi][i * 4 + h * 2 + 1], b1, relu);
          *reinterpret_cast<__nv_bfloat162*>(staging + (i / 8) * BOX + r * 128 +
                                             (((i % 8) ^ (r & 7)) << 4) + t4 * 4) =
              __floats2bfloat162_rn(v0, v1);
          if (r < positions && first + r < s.H * s.W) {  // a position of the image
            s0 += v0;
            s1 += v1;
            q0 += v0 * v0;
            q1 += v1 * v1;
          }
        }
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        q0 += __shfl_xor_sync(0xffffffffu, q0, m);
        q1 += __shfl_xor_sync(0xffffffffu, q1, m);
      }
      if (g == 0) {
        float* r = red + warp * BN + i * 8 + t4 * 2;
        r[0] = s0;
        r[1] = s1;
        r[CONSUMER_WARPS * BN] = q0;
        r[CONSUMER_WARPS * BN + 1] = q1;
      }
    }
    // The TMA store reads the staging tile through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
    if (tid == 0) {
      for (int h = 0; h < BN / 64 && tile.n0 + h * 64 < s.O; ++h)
        tma_store_4d(&to, staging + h * BOX, tile.n0 + h * 64, 0, tile.y0, tile.img);
      bulk_commit();
    }
    if (tid < BN && tile.n0 + tid < s.O) {
      float ts = 0.f, tq = 0.f;
      for (int wp = 0; wp < CONSUMER_WARPS; ++wp) {
        ts += red[wp * BN + tid];
        tq += red[(CONSUMER_WARPS + wp) * BN + tid];
      }
      const size_t o = ((size_t)tile.img * s.row_tiles + tile.mt) * s.O + tile.n0 + tid;
      psum[o] = ts;
      psq[o] = tq;
    }
    // red is read before the next tile's epilogue writes it.
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
  }
  if (tid == 0) bulk_wait<0>();
}

struct Launch {
  const void *x, *w, *bias;
  void *out, *psum, *psq, *sums, *sumsqs;
  int B, Hp, Wp, C, O, relu, grid;
  cudaStream_t stream;
};

// The TMA maps of x (4-D: [C, Wp, Hp, B], {64, W, rows, 1} boxes), w
// (3-D: [O, C, 9], {64, 64, 1} boxes) and out (4-D: [O, W, H, B],
// {64, W, rows, 1} boxes), all in the 128-byte swizzle, with rows =
// floor(bm / W). Loads outside the tensors arrive as zeros; stores outside
// them are dropped.
cudaError_t encode_maps(const Launch& l, int bm, CUtensorMap* tx, CUtensorMap* tw,
                        CUtensorMap* to) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t xdim[4] = {(cuuint64_t)l.C, (cuuint64_t)l.Wp, (cuuint64_t)l.Hp,
                              (cuuint64_t)l.B};
  const cuuint64_t xstride[3] = {(cuuint64_t)l.C * 2, (cuuint64_t)l.Wp * l.C * 2,
                                 (cuuint64_t)l.Hp * l.Wp * l.C * 2};
  const cuuint32_t rows = (cuuint32_t)(bm / (l.Wp - 2));
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)(l.Wp - 2), rows, 1};
  const cuuint64_t wdim[3] = {(cuuint64_t)l.O, (cuuint64_t)l.C, 9};
  const cuuint64_t wstride[2] = {(cuuint64_t)l.O * 2, (cuuint64_t)l.C * l.O * 2};
  const cuuint32_t wbox[3] = {64, BK, 1}, ones[4] = {1, 1, 1, 1};
  const cuuint64_t odim[4] = {(cuuint64_t)l.O, (cuuint64_t)(l.Wp - 2), (cuuint64_t)(l.Hp - 2),
                              (cuuint64_t)l.B};
  const cuuint64_t ostride[3] = {(cuuint64_t)l.O * 2, odim[1] * l.O * 2,
                                 odim[2] * odim[1] * l.O * 2};
  const cuuint32_t obox[4] = {64, (cuuint32_t)(l.Wp - 2), rows, 1};
  if (encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(l.x), xdim, xstride,
             xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(l.w), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, l.out, odim, ostride, obox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int BM, int STAGES>
int launch(const Launch& l) {
  static hopper::Granted granted;
  const int W = l.Wp - 2, H = l.Hp - 2;
  // The box form: at least one whole output row per tile (TMA boxes are at
  // most 256 wide), TMA's 16-byte strides and bases (C and O multiples of 8,
  // 16-byte aligned x, w and out).
  if (W < 1 || W > 256 || W > BM || H < 1 || l.C % 8 != 0 || l.O % 8 != 0 || l.grid < 1 ||
      ((reinterpret_cast<uintptr_t>(l.x) | reinterpret_cast<uintptr_t>(l.w) |
        reinterpret_cast<uintptr_t>(l.out)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<BM, STAGES>();
  cudaError_t err = hopper::allow_smem(conv3x3_wgmma_kernel<BM, STAGES>, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.H = H;
  s.W = W;
  s.O = l.O;
  s.rows = BM / W;
  s.row_tiles = (H + s.rows - 1) / s.rows;
  s.n_tiles = (l.O + BN - 1) / BN;
  s.tiles = l.B * s.row_tiles * s.n_tiles;
  s.chunks = (l.C + BK - 1) / BK;
  CUtensorMap tx = {}, tw = {}, to = {};
  if ((err = encode_maps(l, BM, &tx, &tw, &to)) != cudaSuccess) return static_cast<int>(err);
  conv3x3_wgmma_kernel<BM, STAGES><<<l.grid, NT, smem, l.stream>>>(
      tx, tw, to, static_cast<const float*>(l.bias), static_cast<float*>(l.psum),
      static_cast<float*>(l.psq), s, l.relu);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n = l.B * l.O;
  conv3x3::tile_sums_kernel<<<(n + 255) / 256, 256, 0, l.stream>>>(
      static_cast<const float*>(l.psum), static_cast<const float*>(l.psq),
      static_cast<float*>(l.sums), static_cast<float*>(l.sumsqs), l.B, s.row_tiles, l.O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stx_conv3x3_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, Hp, Wp, C] and w [3, 3, C, O] bf16, bias [O] f32, out [B, Hp-2, Wp-2,
// O] bf16, psum/psq [B, row tiles, O] f32 scratch (row tiles = ceil(H / (bm /
// W))), sums/sumsqs [B, O] f32; on tiles of bm positions with a ring of
// `stages` and a persistent grid of `grid` blocks, one per SM (the wrapper's
// plan). Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for a shape outside the box form or a configuration
// the library does not have).
int stx_conv3x3_wgmma(const void* x, const void* w, const void* bias, void* out, void* psum,
                      void* psq, void* sums, void* sumsqs, int B, int Hp, int Wp, int C, int O,
                      int relu, int bm, int stages, int grid, void* stream) {
  const Launch l{x,  w,  bias, out, psum, psq,  sums, sumsqs, B,
                 Hp, Wp, C,    O,   relu, grid, static_cast<cudaStream_t>(stream)};
  if (bm == 256 && stages == 3) return launch<256, 3>(l);
  if (bm == 128 && stages == 4) return launch<128, 4>(l);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
