// SuperPoint's block 0 in one kernel: conv 3x3 1->64 + bias, ReLU, folded
// BatchNorm; conv 3x3 64->64 + bias, ReLU, folded BatchNorm; 2x2 max pool.
//
// Replaces the Pallas kernel of gluefactory_tpu/ops/pallas_conv.py
// (block0_fused :172, body _make_kernel :77, call :222). What is carried
// over is the function and its rounding points, not the TPU layout work
// (space-to-depth embedding, the widened 24-tap conv1a, WP padding, grid
// chunking):
//   - image and both convs' weights are rounded to bf16; conv1a accumulates
//     in fp32, is cast to bf16, and its bias / ReLU / BN affine run in bf16
//     (every operation rounds);
//   - conv1b zero-pads conv1a's OUTPUT: positions outside the image are 0,
//     not conv1a of a padded image, so the halo of a tile is zeroed at the
//     image border;
//   - conv1b accumulates in fp32; its bias / ReLU / BN affine and the max
//     run in fp32; the pooled output is cast to bf16 once.
//
// One thread block walks over 8 x 8 tiles of pooled outputs (16 x 16 conv1b
// pixels). conv1b's weights (576 x 64, fp32 copies of the bf16 values, 147
// KB) are staged in shared memory once a block; for each tile stage 1
// computes conv1a on the 18 x 18 halo region into shared memory as bf16
// (42 KB) and stage 2 runs the K = 576 product: a thread owns one pooled
// pixel (a 2 x 2 quad of conv1b pixels) and 16 output channels, 64 fp32
// accumulators, and pools in registers. Any even H and W: ragged tiles mask
// their stores.
//
// Bound on the H100: 2 * 576 * 64 flop a pixel, 22.6 GFLOP a 480 x 640
// image, against 1.2 MB of image in and 9.8 MB of features out: bound by
// operations (0.37 ms for 16 images at the bf16 tensor-core peak). This
// first version runs the product on fp32 FMA and cannot pass 67 TFLOP/s;
// tensor-core tiles are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;            // channels of both convs
constexpr int kPool = 8;          // pooled outputs a tile side
constexpr int kPix = 2 * kPool;   // conv1b pixels a tile side
constexpr int kHalo = kPix + 2;   // conv1a outputs a tile side
constexpr int kImg = kPix + 4;    // image pixels a tile side
constexpr int kAPad = kC + 2;     // padded channel stride of the conv1a tile
constexpr int kTaps = 9;

// w2 (576 x 64 fp32), conv1a tile (18 x 18 x 66 bf16), image patch (20 x 20
// fp32), conv1a's weights and affine (12 x 64 fp32), conv1b's affine (3 x 64)
constexpr int kW2Floats = kTaps * kC * kC;
constexpr int kATileBytes = kHalo * kHalo * kAPad * 2;
constexpr int kSmem = kW2Floats * 4 + kATileBytes + (kImg * kImg + 12 * kC + 3 * kC) * 4;

__device__ __forceinline__ float rb(float v) { return gf::round_t<__nv_bfloat16>(v); }

__global__ void __launch_bounds__(kThreads) block0_kernel(
    const float* __restrict__ image, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ mul1,
    const float* __restrict__ add1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ mul2,
    const float* __restrict__ add2, __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  GF_DYN_SMEM(float, smem);
  float* w2s = smem;                                                   // [tap][cin][cout]
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(smem + kW2Floats);  // [pos][kAPad]
  float* img = smem + kW2Floats + kATileBytes / 4;                     // [20][20]
  float* c1 = img + kImg * kImg;   // w1 [9][64], b1, mul1, add1 (bf16 values)
  float* c2 = c1 + 12 * kC;        // b2, mul2, add2 (fp32)

  const int tid = threadIdx.x;
  for (int i = tid; i < kW2Floats; i += kThreads) w2s[i] = rb(w2[i]);
  for (int i = tid; i < kTaps * kC; i += kThreads) c1[i] = rb(w1[i]);
  if (tid < kC) {
    c1[9 * kC + tid] = rb(b1[tid]);
    c1[10 * kC + tid] = rb(mul1[tid]);
    c1[11 * kC + tid] = rb(add1[tid]);
    c2[tid] = b2[tid];
    c2[kC + tid] = mul2[tid];
    c2[2 * kC + tid] = add2[tid];
  }

  const int hp = H / 2, wp = W / 2;
  const int ty_n = (hp + kPool - 1) / kPool, tx_n = (wp + kPool - 1) / kPool;
  const int tiles = B * ty_n * tx_n;

  // stage 1: this thread's channel and its first halo position
  const int ch = tid % kC, pos0 = tid / kC;
  // stage 2: this thread's pooled pixel and its 16 channels
  const int cg = tid % 4, quad = tid / 4, qy = quad / kPool, qx = quad % kPool;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (ty_n * tx_n), rem = tile % (ty_n * tx_n);
    const int y0 = (rem / tx_n) * kPix, x0 = (rem % tx_n) * kPix;  // first conv1b pixel
    __syncthreads();  // the last tile's readers are done (and the constants are in)
    for (int i = tid; i < kImg * kImg; i += kThreads) {
      const int gy = y0 - 2 + i / kImg, gx = x0 - 2 + i % kImg;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      img[i] = in ? rb(image[((size_t)b * H + gy) * W + gx]) : 0.f;
    }
    __syncthreads();

    // conv1a on the halo region; zero outside the image
    float wk[kTaps];
    for (int t = 0; t < kTaps; ++t) wk[t] = c1[t * kC + ch];
    const float bias = c1[9 * kC + ch], mul = c1[10 * kC + ch], add = c1[11 * kC + ch];
    for (int pos = pos0; pos < kHalo * kHalo; pos += kThreads / kC) {
      const int py = pos / kHalo, px = pos % kHalo;
      const int gy = y0 - 1 + py, gx = x0 - 1 + px;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float acc = 0.f;
        for (int t = 0; t < kTaps; ++t)
          acc = fmaf(img[(py + t / 3) * kImg + px + t % 3], wk[t], acc);
        v = rb(acc);
        v = rb(v + bias);
        v = fmaxf(v, 0.f);
        v = rb(v * mul);
        v = rb(v + add);
      }
      at[pos * kAPad + ch] = __float2bfloat16(v);
    }
    __syncthreads();

    // conv1b: acc[pixel of the quad][channel]
    float acc[4][16] = {};
    const __nv_bfloat16* abase = at + ((2 * qy) * kHalo + 2 * qx) * kAPad;
    for (int cin = 0; cin < kC; ++cin) {
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          a[r][c] = __bfloat162float(abase[(r * kHalo + c) * kAPad + cin]);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const float4* wrow =
            reinterpret_cast<const float4*>(w2s + (t * kC + cin) * kC + cg * 16);
        float w[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = wrow[j];
          w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z; w[4 * j + 3] = v.w;
        }
        const int dy = t / 3, dx = t % 3;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float av = a[p / 2 + dy][p % 2 + dx];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[p][j] = fmaf(av, w[j], acc[p][j]);
        }
      }
    }

    const int oy = y0 / 2 + qy, ox = x0 / 2 + qx;
    if (oy < hp && ox < wp) {
      __nv_bfloat16* dst = out + (((size_t)b * hp + oy) * wp + ox) * kC + cg * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = cg * 16 + j;
        float best = 0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float y = fmaxf(acc[p][j] + c2[c], 0.f) * c2[kC + c] + c2[2 * kC + c];
          best = p == 0 ? y : fmaxf(best, y);
        }
        dst[j] = __float2bfloat16(best);
      }
    }
  }
}

}  // namespace

extern "C" {

// image (B, H, W) fp32; w1 (9, 64), w2 (576, 64) fp32 in (tap, cin, cout)
// order; the six affine vectors (64) fp32; out (B, H/2, W/2, 64) bf16.
// `blocks` caps the grid (a block walks over several tiles).
int b0_block0(const void* image, const void* w1, const void* b1, const void* mul1,
              const void* add1, const void* w2, const void* b2, const void* mul2,
              const void* add2, void* out, int B, int H, int W, int blocks, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || blocks < 1) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(block0_kernel, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int hp = H / 2, wp = W / 2;
  const int tiles = B * ((hp + kPool - 1) / kPool) * ((wp + kPool - 1) / kPool);
  const int grid = tiles < blocks ? tiles : blocks;
  GF_LAUNCH(block0_kernel, dim3(grid), kThreads, kSmem, (cudaStream_t)stream,
            (const float*)image, (const float*)w1, (const float*)b1, (const float*)mul1,
            (const float*)add1, (const float*)w2, (const float*)b2, (const float*)mul2,
            (const float*)add2, (__nv_bfloat16*)out, B, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
