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
// One thread block (8 warps) walks over 8 x 8 tiles of pooled outputs (16 x
// 16 conv1b pixels), one block a multiprocessor. conv1b's weights are staged
// once a block as bf16 in shared memory ([tap][cin][cout], 74 KB at a padded
// cout stride). For each tile:
//   - stage 1 computes conv1a on the 18 x 18 halo region as bf16 into a
//     shared-memory tile stored by x parity ([y][x % 2][x / 2][cin], channel
//     stride 72: 144-byte rows, 16-byte aligned, every ldmatrix free of bank
//     conflicts), itself on the tensor cores: 16 halo positions x 9 taps
//     (padded to 16) by 9 taps x 64 channels a bf16 mma.sync, the bf16
//     chain in bf16x2 arithmetic on the accumulators;
//   - stage 2 runs conv1b as an implicit GEMM on the tensor cores: M = the
//     256 pixels, N = 64 output channels, K = 9 taps x 64 input channels,
//     bf16 mma.sync m16n8k16 with fp32 accumulators. A warp owns conv1b rows
//     y and y + 1 as two m16 tiles whose 16 rows are ordered x = 0, 2, .., 14,
//     1, 3, .., 15, so rows g and g + 8 of a C fragment are the two
//     x-neighbours of one pool quad: bias, ReLU, BN and the 2 x 2 max run on
//     a thread's own accumulators. The A operand is read by ldmatrix straight
//     from the conv1a tile (one row address a pixel, shifted by the tap), B
//     by ldmatrix.trans from the weights.
// The conv1a tile and the image patch are double-buffered: the block builds
// tile t + 1's conv1a (and loads tile t + 2's image) while tile t's product
// runs, so warps that finish stage 1 early start on the tensor cores, with
// one barrier a tile. Any even H and W: ragged tiles mask their stores.
//
// Bound on the H100: 2 * 576 * 64 flop a pixel, 22.6 GFLOP a 480 x 640
// image, against 1.2 MB of image in and 9.8 MB of features out: bound by
// operations at the bf16 tensor-core peak (0.19 ms for 8 images).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;            // channels of both convs
constexpr int kPool = 8;          // pooled outputs a tile side
constexpr int kPix = 2 * kPool;   // conv1b pixels a tile side
constexpr int kHalo = kPix + 2;   // conv1a outputs a tile side
constexpr int kHalfW = kHalo / 2; // conv1a outputs of one x parity a row
constexpr int kImg = kPix + 4;    // image pixels a tile side
constexpr int kAPad = kC + 8;     // channel stride of the conv1a tile
constexpr int kWPad = kC + 8;     // cout stride of the staged weights
constexpr int kTaps = 9;
constexpr int kATile = kHalo * kHalo * kAPad;  // bf16 elements of one conv1a tile
constexpr int kW2 = kTaps * kC * kWPad;        // bf16 elements of the weights
constexpr int kImgF = kImg * kImg;

// w2 (bf16), two conv1a tiles (bf16), two image patches (20 x 20 fp32),
// conv1a's weights and affine (12 x 64 fp32), conv1b's affine (3 x 64)
constexpr int kSmem = (kW2 + 2 * kATile) * 2 + (2 * kImgF + 12 * kC + 3 * kC) * 4;

__device__ __forceinline__ float rb(float v) { return gf::round_t<__nv_bfloat16>(v); }

__global__ void __launch_bounds__(kThreads, 1) block0_kernel(
    const float* __restrict__ image, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ mul1,
    const float* __restrict__ add1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ mul2,
    const float* __restrict__ add2, __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  GF_DYN_SMEM(__nv_bfloat16, w2s);   // [tap * 64 + cin][kWPad]
  __nv_bfloat16* at = w2s + kW2;     // [2][y][x % 2][x / 2][kAPad]
  float* img = reinterpret_cast<float*>(at + 2 * kATile);  // [2][20][20]
  float* c1 = img + 2 * kImgF;       // w1 [9][64], b1, mul1, add1 (bf16 values)
  float* c2 = c1 + 12 * kC;          // b2, mul2, add2 (fp32)

  const int tid = threadIdx.x;
  for (int i = tid; i < kTaps * kC * kC; i += kThreads)
    w2s[i / kC * kWPad + i % kC] = __float2bfloat16(w2[i]);
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
  // a tile's image, and its first conv1b pixel
  auto origin = [&](int tile, int& b, int& y0, int& x0) {
    b = tile / (ty_n * tx_n);
    const int rem = tile % (ty_n * tx_n);
    y0 = rem / tx_n * kPix;
    x0 = rem % tx_n * kPix;
  };
  // pixel i of a tile's 20 x 20 image patch, not yet rounded; 0 outside the image
  auto pixel = [&](int tile, int i) {
    int b, y0, x0;
    origin(tile, b, y0, x0);
    const int gy = y0 - 2 + i / kImg, gx = x0 - 2 + i % kImg;
    return gy >= 0 && gy < H && gx >= 0 && gx < W ? image[((size_t)b * H + gy) * W + gx] : 0.f;
  };
  __syncthreads();  // the constants are in

  // stage 1 on the tensor cores too: conv1a as a GEMM of 16 halo positions x
  // 16 taps (9 used; image and w1 are bf16 values, their products exact in
  // the fp32 sums) by 16 taps x 64 channels. A warp takes m16 tiles of the
  // halo in the conv1a tile's storage order, so its stores are free of bank
  // conflicts; the bf16 chain runs on the channel pairs of a C fragment
  // (bf16x2 arithmetic that rounds once an operation, as the rounding points
  // ask: the _rn forms, which the compiler may not fuse into an fma).
  const int lane = tid % 32, w = tid / 32, g = lane / 4, t4 = lane % 4;
  unsigned wb[8][2];  // w1 as B: (taps 2 t4, 2 t4 + 1 | tap 8 for t4 = 0) x channel 8 nt + g
  __nv_bfloat162 bias[8], mul[8], add[8];  // the affine of channels 8 nt + 2 t4, + 1
  for (int nt = 0; nt < 8; ++nt) {
    const int c = 8 * nt + g, cp = 8 * nt + 2 * t4;
    wb[nt][0] = gf::pack_bf16(c1[2 * t4 * kC + c], c1[(2 * t4 + 1) * kC + c]);
    wb[nt][1] = gf::pack_bf16(t4 == 0 ? c1[8 * kC + c] : 0.f, 0.f);
    bias[nt] = __floats2bfloat162_rn(c1[9 * kC + cp], c1[9 * kC + cp + 1]);
    mul[nt] = __floats2bfloat162_rn(c1[10 * kC + cp], c1[10 * kC + cp + 1]);
    add[nt] = __floats2bfloat162_rn(c1[11 * kC + cp], c1[11 * kC + cp + 1]);
  }
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  auto conv1a = [&](int tile, const float* im, __nv_bfloat16* dst) {
    int b, y0, x0;
    origin(tile, b, y0, x0);
    for (int mt = w; mt * 16 < kHalo * kHalo; mt += kThreads / 32) {
      // rows g and g + 8: storage slots 16 mt + g (+8) = (y * 2 + x % 2) * 9 + x / 2
      unsigned a[4];
      bool inside[2];
      for (int h = 0; h < 2; ++h) {
        const int sl = 16 * mt + g + 8 * h;
        const int py = sl / kHalo, px = 2 * (sl % kHalfW) + sl % kHalo / kHalfW;
        const int gy = y0 - 1 + py, gx = x0 - 1 + px;
        const bool real = sl < kHalo * kHalo;
        inside[h] = real && gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float* p = im + (real ? py * kImg + px : 0);  // the position's 3 x 3 window
        const int k0 = 2 * t4;
        a[h] = gf::pack_bf16(p[k0 / 3 * kImg + k0 % 3], p[(k0 + 1) / 3 * kImg + (k0 + 1) % 3]);
        a[2 + h] = gf::pack_bf16(t4 == 0 ? p[2 * kImg + 2] : 0.f, 0.f);
      }
      float acc[8][4] = {};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) gf::mma_bf16_m16n8k16(acc[nt], a, wb[nt]);
      for (int h = 0; h < 2; ++h) {
        const int sl = 16 * mt + g + 8 * h;
        if (sl >= kHalo * kHalo) continue;
        __nv_bfloat16* row = dst + sl * kAPad + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          __nv_bfloat162 v = zero;  // conv1b zero-pads conv1a's output
          if (inside[h]) {
            v = __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
            v = __hadd2_rn(v, bias[nt]);
            v = __hmax2(v, zero);
            v = __hmul2_rn(v, mul[nt]);  // _rn: no contraction into an fma with the add
            v = __hadd2_rn(v, add[nt]);
          }
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt) = v;
        }
      }
    }
  };

  // stage 2: warp w owns conv1b rows 2w, 2w + 1, i.e. pooled row w
  const int mat = lane / 8, mrow = lane % 8;  // the ldmatrix matrix and row this lane addresses
  auto conv1b = [&](int tile, const __nv_bfloat16* A) {
    float acc[2][8][4] = {};
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // m16 row (mat % 2) * 8 + mrow is pixel x = 2 mrow + mat % 2; shifted by the tap
      const int sx = mat % 2 + dx;
      const __nv_bfloat16* a0 =
          A + (((2 * w + dy) * 2 + sx % 2) * kHalfW + mrow + sx / 2) * kAPad + mat / 2 * 8;
      const __nv_bfloat16* a1 = a0 + 2 * kHalfW * kAPad;  // conv1b row 2w + 1
      const __nv_bfloat16* bw = w2s + (tap * kC + mat % 2 * 8 + mrow) * kWPad + mat / 2 * 8;
#pragma unroll
      for (int kc = 0; kc < kC / 16; ++kc) {
        unsigned fa0[4], fa1[4];
        gf::ldsm_x4(fa0, a0 + 16 * kc);
        gf::ldsm_x4(fa1, a1 + 16 * kc);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned fb[4];
          gf::ldsm_x4_trans(fb, bw + 16 * kc * kWPad + 16 * np);
          gf::mma_bf16_m16n8k16(acc[0][2 * np], fa0, fb);
          gf::mma_bf16_m16n8k16(acc[0][2 * np + 1], fa0, fb + 2);
          gf::mma_bf16_m16n8k16(acc[1][2 * np], fa1, fb);
          gf::mma_bf16_m16n8k16(acc[1][2 * np + 1], fa1, fb + 2);
        }
      }
    }
    // c0, c1: pixel x = 2g, c2, c3: x = 2g + 1, channels 8 nt + 2 t4 (+1)
    int b, y0, x0;
    origin(tile, b, y0, x0);
    const int oy = y0 / 2 + w, ox = x0 / 2 + g;
    if (oy >= hp || ox >= wp) return;
    __nv_bfloat16* dst = out + (((size_t)b * hp + oy) * wp + ox) * kC + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float best[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * nt + 2 * t4 + j;
        const float bc = c2[c], mc = c2[kC + c], ac = c2[2 * kC + c];
        float m = 0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float y = fmaxf(acc[p / 2][nt][2 * (p % 2) + j] + bc, 0.f) * mc + ac;
          m = p == 0 ? y : fmaxf(m, y);
        }
        best[j] = m;
      }
      *reinterpret_cast<unsigned*>(dst + 8 * nt) = gf::pack_bf16(best[0], best[1]);
    }
  };

  int tile = blockIdx.x;
  if (tile >= tiles) return;
  for (int i = tid; i < kImgF; i += kThreads) img[i] = rb(pixel(tile, i));
  __syncthreads();
  conv1a(tile, img, at);
  if (tile + (int)gridDim.x < tiles)
    for (int i = tid; i < kImgF; i += kThreads) img[kImgF + i] = rb(pixel(tile + gridDim.x, i));
  __syncthreads();
  for (int n = 0; tile < tiles; ++n, tile += gridDim.x) {
    // buffers n % 2 hold this tile's conv1a; the others get the next tile's
    const int cur = n % 2, next = tile + gridDim.x, next2 = next + gridDim.x;
    if (next < tiles) conv1a(next, img + (1 - cur) * kImgF, at + (1 - cur) * kATile);
    float pre[(kImgF + kThreads - 1) / kThreads];  // tile n + 2's image, in flight
    if (next2 < tiles)
      for (int r = 0; r * kThreads + tid < kImgF; ++r) pre[r] = pixel(next2, r * kThreads + tid);
    conv1b(tile, at + cur * kATile);
    if (next2 < tiles)
      for (int r = 0; r * kThreads + tid < kImgF; ++r)
        img[cur * kImgF + r * kThreads + tid] = rb(pre[r]);
    __syncthreads();
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
