// LightGlue self and cross blocks as a short chain of hand-written kernels.
//
// Replaces the Pallas whole-block megakernels of
// gluefactory_tpu/ops/pallas_lightglue_block.py:
//   fused_self_block     (:309, body _self_block_kernel :117)
//   fused_cross_block    (:374, body _cross_block_kernel :196)
//   fused_self_block_v2  (:641, body :460)   N in (1024, 2048]
//   fused_cross_block_v2 (:698, body :533)   N in (1024, 2048]
// One kernel family, tiled over N, serves every N: the v1/v2 split existed
// only to fit the TPU's 16 MB scoped VMEM.
//
// A TPU grid cell keeps the projected K/V of a whole set in VMEM and runs
// the block in one program. A Hopper block has 227 KB of shared memory and
// no ordering with other blocks, so the block becomes three launches:
//   1. proj: x @ W + b for up to three D-wide weight segments, with the
//      rotary epilogue t*cos + rotate_half(t)*sin and the Dh^-1/2 scale of q
//      fused in (self: q, k, v; cross: the shared qk, and v);
//   2. attention: masked multi-head attention on the packed (S, N, H*Dh)
//      layout, online softmax over key tiles. The key set of query set s
//      is (s + kv_shift) % S: 0 for self attention, B for the cross block,
//      where one launch runs both directions of every pair (rows i and
//      i + B). The cross block recomputes sim10 = sim01^T instead of the
//      TPU kernel's single-similarity form, which needs column statistics
//      reduced across blocks (a later version);
//   3. FFN tail: out-proj, [x, msg] @ W1 as two half-K products, fp32
//      LayerNorm (eps 1e-5), exact-erf GELU, @ W2, residual.
// q, k, v, the context and the message are rounded to the activation type
// between the products, as ops/lightglue_block.py's plain version does.
//
// Bound on the H100: at S = 16, N = 1024, D = 256 the self block does
// ~39 GFLOP on ~17 MB of I/O, far above the card's ~295 FLOP/byte ridge, so
// it is compute-bound, on the tensor cores for bf16.
//
// bf16 (namespace tc, the serving path): every product is mma.sync
// m16n8k16 with fp32 accumulators, operands staged in bf16 shared memory
// by cp.async and read into fragments by ldmatrix (.trans for the row-major
// (in, out) weights and for V, so no transposed copy of a weight is kept).
//   proj       128 x 128 tiles, 8 warps of 64 x 32, 3 stages of 32-deep
//              tiles (55.5 KB of shared memory, 126 registers: two blocks an
//              SM); the epilogue reads a row group's operands before it
//              stores them;
//   attention  the bf16 tile of attention_fwd.cuh, shared with the
//              training forwards (attn_kernel<__nv_bfloat16>): 128 queries
//              a block, a warp owns 16, 64-key K/V tiles double-buffered
//              (54.1 KB, two blocks an SM); the softmax runs in registers
//              with quad shuffles; P goes to bf16 in registers as the A
//              operand of P V, as the Pallas kernel rounds e.astype(cd)
//              (:174, :255); a key tile with no valid key is skipped;
//   FFN tail   64 rows a block, so the 0.92 MB of weights are read once for
//              every 64 rows (the fp32 kernel: every 16); 256-column chunks,
//              16-deep weight tiles in a four-stage cp.async ring; h (64 x 512
//              fp32) is staged in shared memory for the LayerNorm (a warp a
//              row); 227 KB of shared memory, 120 registers: one block an SM.
// Register counts are nvcc 12.8's (-Xptxas -v, no spills); the build log
// _build/lightglue_block.log has them, and chip_smoke.py prints them. Next:
// wgmma with TMA-fed shared-memory rings and warp specialisation; the CPU
// emulation of tests/cuda_emu cannot hold wgmma's shared-memory
// descriptors, and mma.sync already closes the largest gap (fp32 FMA at 67
// TFLOP/s).
//
// fp32 (the parity path): the first version's FMA kernels, 4x4 register
// micro-tiles over 64x64 shared-memory tiles, at the 67 TFLOP/s fp32 rate,
// for proj and the FFN tail; the attention is the training forward's tile
// (attention_fwd.cuh, split-TF32 mma.sync at fp32 accuracy); the
// intermediates q/k/v/ctx make one round trip through device memory.
#include "attention_fwd.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows and columns of an output tile
constexpr int kKc = 32;     // depth of one shared-memory stage
constexpr int kPad = 68;    // padded row length of the 64-wide tiles
constexpr int kDh = 64;     // head width the attention kernel supports
constexpr int kD = 256;     // model width the FFN tail supports
constexpr int kRows = 16;   // rows per FFN-tail block

// ---------------------------------------------------------------- proj
template <class T>
__global__ void __launch_bounds__(kThreads) proj_kernel(
    const T* __restrict__ x, int rows, int K,
    const T* w0, const T* w1, const T* w2, int ldw,
    const T* b0, const T* b1, const T* b2,
    T* o0, T* o1, T* o2, int D,
    const T* __restrict__ cos_t, const T* __restrict__ sin_t, int dh,
    int rotary_segs, float q_scale) {
  __shared__ float As[kKc][kPad];
  __shared__ float Bs[kKc][kPad];
  const int seg = blockIdx.z;
  const T* w = seg == 0 ? w0 : (seg == 1 ? w1 : w2);
  const T* bias = seg == 0 ? b0 : (seg == 1 ? b1 : b2);
  T* out = seg == 0 ? o0 : (seg == 1 ? o1 : o2);
  const int row0 = blockIdx.x * kTile;
  const int col0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kKc) {
    for (int e = 0; e < kTile * kKc / kThreads; ++e) {
      int idx = tid + e * kThreads;
      int r = idx / kKc, kk = idx % kKc;
      int gr = row0 + r;
      As[kk][r] = gr < rows ? gf::to_f(x[(size_t)gr * K + k0 + kk]) : 0.f;
      int kb = idx / kTile, c = idx % kTile;
      Bs[kb][c] = gf::to_f(w[(size_t)(k0 + kb) * ldw + col0 + c]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKc; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool rotary = seg < rotary_segs;
  const float post = (rotary && seg == 0) ? q_scale : 1.f;
  for (int i = 0; i < 4; ++i) {
    int r = row0 + ty * 4 + i;
    if (r >= rows) continue;
    float v[4];
    for (int j = 0; j < 4; ++j) v[j] = acc[i][j] + gf::to_f(bias[col0 + tx * 4 + j]);
    if (rotary) {
      for (int j = 0; j < 4; j += 2) {
        int c = (col0 + tx * 4 + j) % dh;
        size_t t = (size_t)r * dh + c;
        float ce = gf::to_f(cos_t[t]), co = gf::to_f(cos_t[t + 1]);
        float se = gf::to_f(sin_t[t]), so = gf::to_f(sin_t[t + 1]);
        float ve = v[j], vo = v[j + 1];
        v[j] = ve * ce - vo * se;
        v[j + 1] = vo * co + ve * so;
      }
    }
    for (int j = 0; j < 4; ++j)
      out[(size_t)r * D + col0 + tx * 4 + j] = gf::from_f<T>(v[j] * post);
  }
}

// ----------------------------------------------------------- attention
// grid (ceil(N / gf::FwdTile<T>::kQueries), H, S); the tile itself is
// gf::attn_fwd_tile<T> (attention_fwd.cuh), shared with the training
// attention kernels and capped like them: fp32 64 queries a block at 168
// registers (three blocks a multiprocessor), bf16 128 queries at 128 (two).
template <class T>
__global__ void __launch_bounds__(gf::FwdTile<T>::kThreads, gf::FwdTile<T>::kBlocks) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, T* __restrict__ out,
    int S, int N, int D, int kv_shift, float scale) {
  GF_DYN_SMEM(float, smem);
  const int s = blockIdx.z, h = blockIdx.y;
  const int kvs = (s + kv_shift) % S;
  const size_t qbase = (size_t)s * N * D + h * kDh;
  const size_t kbase = (size_t)kvs * N * D + h * kDh;
  gf::attn_fwd_tile<T>(q + qbase, k + kbase, v + kbase,
                       mask == nullptr ? nullptr : mask + (size_t)s * N,
                       mask == nullptr ? nullptr : mask + (size_t)kvs * N,
                       out + qbase, nullptr, N, N, D, blockIdx.x * gf::FwdTile<T>::kQueries,
                       scale, smem);
}

// ------------------------------------------------------------ FFN tail
// Shared: xs, cs, ms (kRows x kD), hs (kRows x 2kD), Bs (16 x (kD + 4)),
// red (kRows x 16).
constexpr int kFfnKc = 16;
constexpr int kFfnSmem =
    (3 * kRows * kD + 2 * kRows * kD + kFfnKc * (kD + 4) + kRows * 16) * sizeof(float);

// acc[i][j] += A[ty*4+i][:] . W[:, col0 + tx*4 + j] over K, A in shared
// memory with row stride lda, W (K, ldw) row-major in device memory.
template <class T>
__device__ void rows_gemm(const float* A, int lda, const T* __restrict__ W, int ldw,
                          int K, int col0, float acc[4][4], float (*Bs)[kD + 4]) {
  const int tid = threadIdx.x, tx = tid % 64, ty = tid / 64;
  for (int k0 = 0; k0 < K; k0 += kFfnKc) {
    for (int e = 0; e < kFfnKc * kD / kThreads; ++e) {
      int idx = tid + e * kThreads;
      int kk = idx / kD, c = idx % kD;
      Bs[kk][c] = gf::to_f(W[(size_t)(k0 + kk) * ldw + col0 + c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kFfnKc; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * lda + k0 + kk];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads) ffn_tail_kernel(
    const T* __restrict__ x, const T* __restrict__ ctx,
    const T* __restrict__ wout, const T* __restrict__ bout,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ lns, const T* __restrict__ lnb,
    const T* __restrict__ w2, const T* __restrict__ b2,
    T* __restrict__ out, int rows) {
  GF_DYN_SMEM(float, smem);
  float* xs = smem;                    // [kRows][kD]
  float* cs = xs + kRows * kD;         // [kRows][kD]
  float* ms = cs + kRows * kD;         // [kRows][kD]
  float* hs = ms + kRows * kD;         // [kRows][2kD]
  float(*Bs)[kD + 4] = reinterpret_cast<float(*)[kD + 4]>(hs + 2 * kRows * kD);
  float(*red)[16] = reinterpret_cast<float(*)[16]>(hs + 2 * kRows * kD + kFfnKc * (kD + 4));

  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid % 64, ty = tid / 64;

  for (int e = 0; e < kRows * kD / kThreads; ++e) {
    int idx = tid + e * kThreads;
    int r = idx / kD, c = idx % kD;
    bool in = row0 + r < rows;
    size_t g = (size_t)(row0 + r) * kD + c;
    xs[idx] = in ? gf::to_f(x[g]) : 0.f;
    cs[idx] = in ? gf::to_f(ctx[g]) : 0.f;
  }
  __syncthreads();

  // message = ctx @ Wout + bout, rounded to the activation type
  {
    float acc[4][4] = {};
    rows_gemm<T>(cs, kD, wout, kD, kD, 0, acc, Bs);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        int c = tx * 4 + j;
        ms[(ty * 4 + i) * kD + c] = gf::round_t<T>(acc[i][j] + gf::to_f(bout[c]));
      }
  }
  __syncthreads();

  // h = [x, msg] @ W1 + b1 as two half-K products
  for (int c0 = 0; c0 < 2 * kD; c0 += kD) {
    float acc[4][4] = {};
    rows_gemm<T>(xs, kD, w1, 2 * kD, kD, c0, acc, Bs);
    rows_gemm<T>(ms, kD, w1 + (size_t)kD * 2 * kD, 2 * kD, kD, c0, acc, Bs);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        int c = c0 + tx * 4 + j;
        hs[(ty * 4 + i) * 2 * kD + c] = acc[i][j] + gf::to_f(b1[c]);
      }
  }
  __syncthreads();

  // LayerNorm over 2D features in fp32, then exact GELU: 16 threads a row
  {
    const int r = tid / 16, part = tid % 16;
    float* hr = hs + r * 2 * kD;
    const int n_part = 2 * kD / 16;
    float s = 0.f;
    for (int c = part * n_part; c < (part + 1) * n_part; ++c) s += hr[c];
    red[r][part] = s;
    __syncthreads();
    float mean = 0.f;
    for (int t = 0; t < 16; ++t) mean += red[r][t];
    mean /= (2 * kD);
    __syncthreads();
    float sq = 0.f;
    for (int c = part * n_part; c < (part + 1) * n_part; ++c) {
      float dv = hr[c] - mean;
      sq += dv * dv;
    }
    red[r][part] = sq;
    __syncthreads();
    float var = 0.f;
    for (int t = 0; t < 16; ++t) var += red[r][t];
    var /= (2 * kD);
    float rstd = rsqrtf(var + 1e-5f);
    for (int c = part * n_part; c < (part + 1) * n_part; ++c) {
      float y = (hr[c] - mean) * rstd * gf::to_f(lns[c]) + gf::to_f(lnb[c]);
      float g = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
      hr[c] = gf::round_t<T>(g);
    }
  }
  __syncthreads();

  // out = x + g @ W2 + b2
  {
    float acc[4][4] = {};
    rows_gemm<T>(hs, 2 * kD, w2, kD, 2 * kD, 0, acc, Bs);
    for (int i = 0; i < 4; ++i) {
      int r = ty * 4 + i;
      if (row0 + r >= rows) continue;
      for (int j = 0; j < 4; ++j) {
        int c = tx * 4 + j;
        float y = xs[r * kD + c] + acc[i][j] + gf::to_f(b2[c]);
        out[(size_t)(row0 + r) * kD + c] = gf::from_f<T>(y);
      }
    }
  }
}


// ===================================================== tensor-core path (bf16)
// The T = __nv_bfloat16 instantiation of proj and the FFN tail (the
// attention is attn_kernel<__nv_bfloat16> above). Every product is mma.sync
// m16n8k16 (bf16 in, fp32 accumulators) on operands staged in bf16 shared
// memory by cp.async; fragments come from ldmatrix (.trans for the row-major
// weights). Padded row strides (+8 bf16) keep the eight 16-byte rows of
// every ldmatrix on distinct banks.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // 8 warps in every tensor-core kernel

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<unsigned*>(p) = gf::pack_bf16(lo, hi);
}
// p[0] and p[1] in one 32-bit load (p 4-byte aligned)
__device__ __forceinline__ void load_bf16x2(const bf16* p, float& lo, float& hi) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p);
  lo = gf::bf16_lo(v);
  hi = gf::bf16_hi(v);
}

// ---------------------------------------------------------------- proj
// 128 x 128 output tile a block, warps 2 (rows) x 4 (columns) of 64 x 32,
// three cp.async stages of 32-deep A and B tiles.
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kAS = kBK + 8;   // A tile row stride
constexpr int kBS = kBN + 8;   // B tile row stride
constexpr int kProjStage = kBM * kAS + kBK * kBS;            // bf16 a stage
constexpr int kProjSmem = kStages * kProjStage * (int)sizeof(bf16);

__global__ void __launch_bounds__(kThreads) proj_kernel(
    const bf16* __restrict__ x, int rows, int K,
    const bf16* w0, const bf16* w1, const bf16* w2, int ldw,
    const bf16* b0, const bf16* b1, const bf16* b2,
    bf16* o0, bf16* o1, bf16* o2, int D,
    const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t, int dh,
    int rotary_segs, float q_scale) {
  GF_DYN_SMEM(bf16, smem);
  const int seg = blockIdx.z;
  const bf16* w = seg == 0 ? w0 : (seg == 1 ? w1 : w2);
  const bf16* bias = seg == 0 ? b0 : (seg == 1 ? b1 : b2);
  bf16* out = seg == 0 ? o0 : (seg == 1 ? o1 : o2);
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;

  auto load = [&](int stage, int k0) {
    bf16* As = smem + stage * kProjStage;
    bf16* Bs = As + kBM * kAS;
    for (int e = 0; e < kBM * kBK / 8 / kThreads; ++e) {  // A: kBM rows of 16-byte chunks
      int idx = tid + e * kThreads, r = idx / (kBK / 8), c = idx % (kBK / 8) * 8;
      bool in = row0 + r < rows;
      gf::cp_async16(As + r * kAS + c, x + (size_t)(in ? row0 + r : 0) * K + k0 + c, in);
    }
    for (int e = 0; e < kBK * kBN / 8 / kThreads; ++e) {  // B: kBK rows
      int idx = tid + e * kThreads, r = idx / (kBN / 8), c = idx % (kBN / 8) * 8;
      gf::cp_async16(Bs + r * kBS + c, w + (size_t)(k0 + r) * ldw + col0 + c, true);
    }
  };

  float acc[4][4][4] = {};
  const int nk = K / kBK;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st * kBK);
    gf::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gf::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int pf = kt + kStages - 1;
    if (pf < nk) load(pf % kStages, pf * kBK);
    gf::cp_async_commit();
    const bf16* As = smem + (kt % kStages) * kProjStage;
    const bf16* Bs = As + kBM * kAS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        gf::ldsm_x4(a[mi], As + (wm * 64 + mi * 16 + lane % 16) * kAS + kk + (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        gf::ldsm_x4_trans(b[nj], Bs + (kk + (lane / 8) % 2 * 8 + lane % 8) * kBS + wn * 32 +
                                     nj * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          gf::mma_bf16_m16n8k16(acc[mi][ni], a[mi], &b[ni / 2][(ni % 2) * 2]);
    }
  }

  // epilogue: bias, rotary on (even, odd) column pairs, the q scale, bf16.
  // A warp reads the operands of 16 rows before it stores them: a store to
  // `out` may alias a later load as far as the compiler knows, so loads
  // interleaved with stores would each wait out a full memory round trip.
  const bool rotary = seg < rotary_segs;
  const float post = (rotary && seg == 0) ? q_scale : 1.f;
  const int g = lane / 4, t = lane % 4;
  float bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    load_bf16x2(bias + col0 + wn * 32 + ni * 8 + 2 * t, bv[ni][0], bv[ni][1]);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    float cs[2][4][4] = {};  // (cos, cos, sin, sin) of row g + 8h, column pair ni
    if (rotary) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * 64 + mi * 16 + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const size_t tt = (size_t)r * dh + (col0 + wn * 32 + ni * 8 + 2 * t) % dh;
          load_bf16x2(cos_t + tt, cs[h][ni][0], cs[h][ni][1]);
          load_bf16x2(sin_t + tt, cs[h][ni][2], cs[h][ni][3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * 64 + mi * 16 + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float ve = acc[mi][ni][2 * h] + bv[ni][0], vo = acc[mi][ni][2 * h + 1] + bv[ni][1];
        if (rotary) {
          const float* q = cs[h][ni];
          const float e = ve * q[0] - vo * q[2];
          vo = vo * q[1] + ve * q[3];
          ve = e;
        }
        store_bf16x2(out + (size_t)r * D + col0 + wn * 32 + ni * 8 + 2 * t, ve * post,
                     vo * post);
      }
    }
  }
}

// ------------------------------------------------------------ FFN tail
// 64 rows a block (the weights, 0.92 MB of bf16, are read once for every 64
// rows, 4x less often than the 16-row FMA kernel), warps 2 (rows) x 4
// (columns) of 32 x 64 over 256-column chunks of each product. A block runs
// alone on its SM, so the weight tiles (16 deep) keep three in flight in a
// four-stage cp.async ring to cover L2 latency. h (64 x 512, fp32) is
// staged in shared memory for the LayerNorm, which runs a warp a row.
// Shared memory, bytes (one block an SM):
//   xs, ms   2 x 64 x 264 bf16   67,584   (gs, 64 x 520 bf16, reuses them)
//   hs       64 x 512 fp32      131,072   (cs, 64 x 264 bf16, before h)
//   W ring   4 x 16 x 264 bf16   33,792
//   total                       232,448, all of a block's 227 KB
constexpr int kFR = 64, kFX = kD + 8, kFG = 2 * kD + 8, kFH = 2 * kD;
constexpr int kFBK = 16, kFBN = 256, kFWS = kFBN + 8, kFStages = 4;
constexpr int kFfnSmem = 2 * kFR * kFX * (int)sizeof(bf16) + kFR * kFH * (int)sizeof(float) +
                         kFStages * kFBK * kFWS * (int)sizeof(bf16);

// acc += A[64 x K] @ W[K x 256]: A bf16 in shared memory (row stride lda),
// W bf16 row-major in device memory (row stride ldw, first column at W).
// Warp w owns rows (w / 4) * 32.. and columns (w % 4) * 64.. of the chunk.
__device__ __forceinline__ void ffn_gemm(const bf16* As, int lda, const bf16* __restrict__ W,
                                         int ldw, int K, bf16* Ws, float acc[2][8][4]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  auto load = [&](int stage, int k0) {
    for (int e = 0; e < kFBK * (kFBN / 8) / kThreads; ++e) {  // kFBK rows of 16-byte chunks
      int idx = tid + e * kThreads, r = idx / (kFBN / 8), c = idx % (kFBN / 8) * 8;
      gf::cp_async16(Ws + (stage * kFBK + r) * kFWS + c, W + (size_t)(k0 + r) * ldw + c, true);
    }
  };
  const int nk = K / kFBK;
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < nk) load(st, st * kFBK);
    gf::cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    gf::cp_async_wait<kFStages - 2>();
    __syncthreads();  // tile kt (and any earlier copy) landed; tile kt - 1 is free
    const int pf = kt + kFStages - 1;
    if (pf < nk) load(pf % kFStages, pf * kFBK);
    gf::cp_async_commit();
    const bf16* Wt = Ws + (kt % kFStages) * kFBK * kFWS;
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 16) {
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        gf::ldsm_x4(a[mi], As + (wm * 32 + mi * 16 + lane % 16) * lda + kt * kFBK + kk +
                               (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        gf::ldsm_x4_trans(b[nj], Wt + (kk + (lane / 8) % 2 * 8 + lane % 8) * kFWS + wn * 64 +
                                     nj * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          gf::mma_bf16_m16n8k16(acc[mi][ni], a[mi], &b[ni / 2][(ni % 2) * 2]);
    }
  }
  __syncthreads();  // the W ring and A are free for the caller
}

__global__ void __launch_bounds__(kThreads, 1) ffn_tail_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ctx,
    const bf16* __restrict__ wout, const bf16* __restrict__ bout,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ lns, const bf16* __restrict__ lnb,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int rows) {
  GF_DYN_SMEM(unsigned char, raw);
  bf16* xs = reinterpret_cast<bf16*>(raw);                          // [kFR][kFX]
  bf16* ms = xs + kFR * kFX;                                        // [kFR][kFX]
  bf16* gs = xs;                                                    // [kFR][kFG]
  float* hs = reinterpret_cast<float*>(raw + 2 * kFR * kFX * sizeof(bf16));  // [kFR][kFH]
  bf16* cs = reinterpret_cast<bf16*>(hs);                           // [kFR][kFX]
  bf16* Ws = reinterpret_cast<bf16*>(hs + kFR * kFH);
  const int row0 = blockIdx.x * kFR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;

  for (int e = 0; e < kFR * 32 / kThreads; ++e) {  // x, ctx: 64 rows x 32 chunks
    int idx = tid + e * kThreads, r = idx / 32, c = (idx % 32) * 8;
    bool in = row0 + r < rows;
    size_t off = (size_t)(in ? row0 + r : 0) * kD + c;
    gf::cp_async16(xs + r * kFX + c, x + off, in);
    gf::cp_async16(cs + r * kFX + c, ctx + off, in);
  }
  gf::cp_async_commit();

  // (r, c) of accumulator element e of tile (mi, ni) in a chunk
  auto row_of = [&](int mi, int e) { return wm * 32 + mi * 16 + g + 8 * (e / 2); };
  auto col_of = [&](int ni) { return wn * 64 + ni * 8 + 2 * t; };

  // message = ctx @ Wout + bout, rounded to bf16
#pragma unroll 1
  for (int c0 = 0; c0 < kD; c0 += kFBN) {
    float acc[2][8][4] = {};
    ffn_gemm(cs, kFX, wout + c0, kD, kD, Ws, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          int r = row_of(mi, e), c = c0 + col_of(ni);
          float b0, b1v;
          load_bf16x2(bout + c, b0, b1v);
          store_bf16x2(ms + r * kFX + c, acc[mi][ni][e] + b0, acc[mi][ni][e + 1] + b1v);
        }
  }
  // h = [x, msg] @ W1 + b1 as two half-K products, fp32 (over cs)
#pragma unroll 1
  for (int c0 = 0; c0 < 2 * kD; c0 += kFBN) {
    float acc[2][8][4] = {};
    ffn_gemm(xs, kFX, w1 + c0, 2 * kD, kD, Ws, acc);
    ffn_gemm(ms, kFX, w1 + (size_t)kD * 2 * kD + c0, 2 * kD, kD, Ws, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          int r = row_of(mi, e), c = c0 + col_of(ni);
          float b0, b1v;
          load_bf16x2(b1 + c, b0, b1v);
          hs[r * kFH + c] = acc[mi][ni][e] + b0;
          hs[r * kFH + c + 1] = acc[mi][ni][e + 1] + b1v;
        }
  }
  __syncthreads();

  // LayerNorm over 2D features in fp32 (eps 1e-5), exact GELU, bf16 into gs
  // (over xs and ms): a warp a row, 16 values a lane
  for (int rr = 0; rr < kFR / 8; ++rr) {
    const int r = warp * (kFR / 8) + rr;
    float vals[16], sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      vals[i] = hs[r * kFH + lane + 32 * i];
      sum += vals[i];
    }
    for (int off = 16; off > 0; off /= 2) sum += gf::shfl_xor(sum, off);
    const float mean = sum / (2 * kD);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sq += (vals[i] - mean) * (vals[i] - mean);
    for (int off = 16; off > 0; off /= 2) sq += gf::shfl_xor(sq, off);
    const float rstd = rsqrtf(sq / (2 * kD) + 1e-5f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = lane + 32 * i;
      float y = (vals[i] - mean) * rstd * gf::to_f(lns[c]) + gf::to_f(lnb[c]);
      gs[r * kFG + c] = gf::from_f<bf16>(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
    }
  }

  // out = x + (g @ W2 + b2)
#pragma unroll 1
  for (int c0 = 0; c0 < kD; c0 += kFBN) {
    float acc[2][8][4] = {};
    ffn_gemm(gs, kFG, w2 + c0, kD, 2 * kD, Ws, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          int r = row0 + row_of(mi, e), c = c0 + col_of(ni);
          if (r >= rows) continue;
          size_t at = (size_t)r * kD + c;
          float x0, x1, b0, b1v;
          load_bf16x2(x + at, x0, x1);
          load_bf16x2(b2 + c, b0, b1v);
          store_bf16x2(out + at, x0 + (acc[mi][ni][e] + b0), x1 + (acc[mi][ni][e + 1] + b1v));
        }
  }
}

}  // namespace tc

// ------------------------------------------------------------ launchers
template <class T>
int launch_proj(const void* x, int rows, int K, const void* w0, const void* w1,
                const void* w2, int ldw, const void* b0, const void* b1,
                const void* b2, void* o0, void* o1, void* o2, int D, int nseg,
                const void* cos_t, const void* sin_t, int dh, int rotary_segs,
                float q_scale, cudaStream_t stream) {
  if (K % kKc || D % kTile || nseg < 1 || nseg > 3 || (rotary_segs && dh % 4))
    return (int)cudaErrorInvalidValue;
  dim3 grid((rows + kTile - 1) / kTile, D / kTile, nseg);
  GF_LAUNCH(proj_kernel<T>, grid, kThreads, 0, stream, (const T*)x, rows, K,
            (const T*)w0, (const T*)w1, (const T*)w2, ldw, (const T*)b0,
            (const T*)b1, (const T*)b2, (T*)o0, (T*)o1, (T*)o2, D,
            (const T*)cos_t, (const T*)sin_t, dh, rotary_segs, q_scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_attn(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, int S, int N, int D,
                int H, int kv_shift, float scale, cudaStream_t stream) {
  using Tile = gf::FwdTile<T>;
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(attn_kernel<T>, Tile::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + Tile::kQueries - 1) / Tile::kQueries, H, S);
  GF_LAUNCH(attn_kernel<T>, grid, Tile::kThreads, Tile::kSmem, stream, (const T*)q,
            (const T*)k, (const T*)v, mask, (T*)out, S, N, D, kv_shift, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_ffn(const void* x, const void* ctx, const void* wout, const void* bout,
               const void* w1, const void* b1, const void* lns, const void* lnb,
               const void* w2, const void* b2, void* out, int rows, int D,
               cudaStream_t stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(ffn_tail_kernel<T>, kFfnSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((rows + kRows - 1) / kRows);
  GF_LAUNCH(ffn_tail_kernel<T>, grid, kThreads, kFfnSmem, stream, (const T*)x,
            (const T*)ctx, (const T*)wout, (const T*)bout, (const T*)w1,
            (const T*)b1, (const T*)lns, (const T*)lnb, (const T*)w2,
            (const T*)b2, (T*)out, rows);
  return (int)cudaGetLastError();
}


// the bf16 instantiations: the tensor-core kernels
int launch_proj_tc(const void* x, int rows, int K, const void* w0, const void* w1,
                   const void* w2, int ldw, const void* b0, const void* b1, const void* b2,
                   void* o0, void* o1, void* o2, int D, int nseg, const void* cos_t,
                   const void* sin_t, int dh, int rotary_segs, float q_scale,
                   cudaStream_t stream) {
  using tc::bf16;
  if (K % tc::kBK || D % tc::kBN || ldw % 8 || nseg < 1 || nseg > 3 ||
      (rotary_segs && dh % 4))
    return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(tc::proj_kernel, tc::kProjSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((rows + tc::kBM - 1) / tc::kBM, D / tc::kBN, nseg);
  GF_LAUNCH(tc::proj_kernel, grid, tc::kThreads, tc::kProjSmem, stream, (const bf16*)x, rows,
            K, (const bf16*)w0, (const bf16*)w1, (const bf16*)w2, ldw, (const bf16*)b0,
            (const bf16*)b1, (const bf16*)b2, (bf16*)o0, (bf16*)o1, (bf16*)o2, D,
            (const bf16*)cos_t, (const bf16*)sin_t, dh, rotary_segs, q_scale);
  return (int)cudaGetLastError();
}

int launch_ffn_tc(const void* x, const void* ctx, const void* wout, const void* bout,
                  const void* w1, const void* b1, const void* lns, const void* lnb,
                  const void* w2, const void* b2, void* out, int rows, int D,
                  cudaStream_t stream) {
  using tc::bf16;
  if (D != kD) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(tc::ffn_tail_kernel, tc::kFfnSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((rows + tc::kFR - 1) / tc::kFR);
  GF_LAUNCH(tc::ffn_tail_kernel, grid, tc::kThreads, tc::kFfnSmem, stream, (const bf16*)x,
            (const bf16*)ctx, (const bf16*)wout, (const bf16*)bout, (const bf16*)w1,
            (const bf16*)b1, (const bf16*)lns, (const bf16*)lnb, (const bf16*)w2,
            (const bf16*)b2, (bf16*)out, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lg_proj(const void* x, int rows, int K, const void* w0, const void* w1,
            const void* w2, int ldw, const void* b0, const void* b1, const void* b2,
            void* o0, void* o1, void* o2, int D, int nseg, const void* cos_t,
            const void* sin_t, int dh, int rotary_segs, float q_scale, int dtype,
            void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == gf::kBF16)
    return launch_proj_tc(x, rows, K, w0, w1, w2, ldw, b0, b1, b2, o0, o1, o2, D, nseg, cos_t,
                          sin_t, dh, rotary_segs, q_scale, st);
  return launch_proj<float>(x, rows, K, w0, w1, w2, ldw, b0, b1, b2, o0, o1, o2, D,
                            nseg, cos_t, sin_t, dh, rotary_segs, q_scale, st);
}

int lg_attention(const void* q, const void* k, const void* v, const void* mask,
                 void* out, int S, int N, int D, int H, int kv_shift, float scale,
                 int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto mk = (const unsigned char*)mask;
  if (dtype == gf::kBF16)
    return launch_attn<tc::bf16>(q, k, v, mk, out, S, N, D, H, kv_shift, scale, st);
  return launch_attn<float>(q, k, v, mk, out, S, N, D, H, kv_shift, scale, st);
}

int lg_ffn_tail(const void* x, const void* ctx, const void* wout, const void* bout,
                const void* w1, const void* b1, const void* lns, const void* lnb,
                const void* w2, const void* b2, void* out, int rows, int D, int dtype,
                void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == gf::kBF16)
    return launch_ffn_tc(x, ctx, wout, bout, w1, b1, lns, lnb, w2, b2, out, rows, D, st);
  return launch_ffn<float>(x, ctx, wout, bout, w1, b1, lns, lnb, w2, b2, out, rows, D,
                           st);
}

}  // extern "C"
