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
//   1. proj_kernel: x @ W + b for up to three D-wide weight segments, with
//      the rotary epilogue t*cos + rotate_half(t)*sin and the Dh^-1/2 scale
//      of q fused in (self: q, k, v; cross: the shared qk, and v);
//   2. attn_kernel: masked multi-head attention on the packed (S, N, H*Dh)
//      layout, online softmax over 64-key tiles. The key set of query set s
//      is (s + kv_shift) % S: 0 for self attention, B for the cross block,
//      where one launch runs both directions of every pair (rows i and
//      i + B). The cross block recomputes sim10 = sim01^T instead of the
//      TPU kernel's single-similarity form; sharing it is a later
//      optimisation;
//   3. ffn_tail_kernel: out-proj, [x, msg] @ W1 as two half-K products,
//      fp32 LayerNorm (eps 1e-5), exact-erf GELU, @ W2, residual.
//
// Bound on the H100: at S = 16, N = 1024, D = 256 the self block does
// ~39 GFLOP on ~17 MB of I/O, far above the card's ~295 FLOP/byte ridge, so
// it is compute-bound. This first version computes in fp32 FMA (4x4
// register micro-tiles over 64x64 shared-memory tiles, bf16 or fp32 I/O)
// and so runs against the 67 TFLOP/s fp32 rate, not the tensor cores; the
// intermediates q/k/v/ctx make one round trip through device memory (L2 at
// these sizes). Moving the products to wgmma and keeping K/V in shared
// memory across a cluster is the work of later versions.
#include "common.cuh"

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
// grid (ceil(N / 64), H, S); shared: Qs, Ks, Vs, Ps (64 x kPad each),
// red (64 x 17), kvalid (64).
constexpr int kAttnSmem = (4 * kTile * kPad + kTile * 17 + kTile) * sizeof(float);

template <class T>
__global__ void __launch_bounds__(kThreads) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, T* __restrict__ out,
    int S, int N, int D, int kv_shift, float scale) {
  GF_DYN_SMEM(float, smem);
  float(*Qs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem);          // [d][r]
  float(*Ks)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + kTile * kPad);  // [d][c]
  float(*Vs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 2 * kTile * kPad);  // [j][c]
  float(*Ps)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 3 * kTile * kPad);  // [j][r]
  float(*red)[17] = reinterpret_cast<float(*)[17]>(smem + 4 * kTile * kPad);
  float* kvalid = smem + 4 * kTile * kPad + kTile * 17;

  const int s = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTile;
  const int kvs = (s + kv_shift) % S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qbase = (size_t)s * N * D + h * kDh;
  const size_t kbase = (size_t)kvs * N * D + h * kDh;

  for (int e = 0; e < kTile * kDh / kThreads; ++e) {
    int idx = tid + e * kThreads;
    int r = idx / kDh, d = idx % kDh;
    int gi = i0 + r;
    Qs[d][r] = gi < N ? gf::to_f(q[qbase + (size_t)gi * D + d]) : 0.f;
  }
  bool qv[4];
  for (int i = 0; i < 4; ++i) {
    int gi = i0 + ty * 4 + i;
    qv[i] = gi < N && (mask == nullptr || mask[(size_t)s * N + gi]);
  }

  const float kNone = -1e30f;
  float m[4], l[4], o[4][4] = {};
  for (int i = 0; i < 4; ++i) { m[i] = kNone; l[i] = 0.f; }

  for (int j0 = 0; j0 < N; j0 += kTile) {
    __syncthreads();
    for (int e = 0; e < kTile * kDh / kThreads; ++e) {
      int idx = tid + e * kThreads;
      int c = idx / kDh, d = idx % kDh;
      int gj = j0 + c;
      bool in = gj < N;
      Ks[d][c] = in ? gf::to_f(k[kbase + (size_t)gj * D + d]) : 0.f;
      Vs[c][d] = in ? gf::to_f(v[kbase + (size_t)gj * D + d]) : 0.f;
    }
    if (tid < kTile) {
      int gj = j0 + tid;
      kvalid[tid] = (gj < N && (mask == nullptr || mask[(size_t)kvs * N + gj])) ? 1.f : 0.f;
    }
    __syncthreads();

    float sim[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = Qs[d][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Ks[d][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) sim[i][j] = fmaf(a[i], b[j], sim[i][j]);
    }
    bool kv[4];
    for (int j = 0; j < 4; ++j) kv[j] = kvalid[tx * 4 + j] > 0.f;
    for (int i = 0; i < 4; ++i) {
      float pm = kNone;
      for (int j = 0; j < 4; ++j) {
        sim[i][j] = kv[j] ? sim[i][j] * scale : kNone;
        pm = fmaxf(pm, sim[i][j]);
      }
      red[ty * 4 + i][tx] = pm;
    }
    __syncthreads();
    float mnew[4];
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
      for (int t = 0; t < 16; ++t) mx = fmaxf(mx, red[ty * 4 + i][t]);
      mnew[i] = mx;
    }
    __syncthreads();
    for (int i = 0; i < 4; ++i) {
      float ps = 0.f;
      for (int j = 0; j < 4; ++j) {
        float p = kv[j] ? expf(sim[i][j] - mnew[i]) : 0.f;
        Ps[tx * 4 + j][ty * 4 + i] = p;
        ps += p;
      }
      red[ty * 4 + i][tx] = ps;
    }
    __syncthreads();
    for (int i = 0; i < 4; ++i) {
      float alpha = expf(m[i] - mnew[i]);
      float ls = 0.f;
      for (int t = 0; t < 16; ++t) ls += red[ty * 4 + i][t];
      l[i] = l[i] * alpha + ls;
      m[i] = mnew[i];
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = Ps[jj][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Vs[jj][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
    }
  }

  for (int i = 0; i < 4; ++i) {
    int gi = i0 + ty * 4 + i;
    if (gi >= N) continue;
    float inv = (qv[i] && l[i] > 0.f) ? 1.f / l[i] : 0.f;
    for (int j = 0; j < 4; ++j)
      out[qbase + (size_t)gi * D + tx * 4 + j] = gf::from_f<T>(o[i][j] * inv);
  }
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
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(attn_kernel<T>, kAttnSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + kTile - 1) / kTile, H, S);
  GF_LAUNCH(attn_kernel<T>, grid, kThreads, kAttnSmem, stream, (const T*)q,
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

}  // namespace

extern "C" {

int lg_proj(const void* x, int rows, int K, const void* w0, const void* w1,
            const void* w2, int ldw, const void* b0, const void* b1, const void* b2,
            void* o0, void* o1, void* o2, int D, int nseg, const void* cos_t,
            const void* sin_t, int dh, int rotary_segs, float q_scale, int dtype,
            void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == gf::kBF16)
    return launch_proj<__nv_bfloat16>(x, rows, K, w0, w1, w2, ldw, b0, b1, b2, o0, o1,
                                      o2, D, nseg, cos_t, sin_t, dh, rotary_segs,
                                      q_scale, st);
  return launch_proj<float>(x, rows, K, w0, w1, w2, ldw, b0, b1, b2, o0, o1, o2, D,
                            nseg, cos_t, sin_t, dh, rotary_segs, q_scale, st);
}

int lg_attention(const void* q, const void* k, const void* v, const void* mask,
                 void* out, int S, int N, int D, int H, int kv_shift, float scale,
                 int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto mk = (const unsigned char*)mask;
  if (dtype == gf::kBF16)
    return launch_attn<__nv_bfloat16>(q, k, v, mk, out, S, N, D, H, kv_shift, scale, st);
  return launch_attn<float>(q, k, v, mk, out, S, N, D, H, kv_shift, scale, st);
}

int lg_ffn_tail(const void* x, const void* ctx, const void* wout, const void* bout,
                const void* w1, const void* b1, const void* lns, const void* lnb,
                const void* w2, const void* b2, void* out, int rows, int D, int dtype,
                void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == gf::kBF16)
    return launch_ffn<__nv_bfloat16>(x, ctx, wout, bout, w1, b1, lns, lnb, w2, b2, out,
                                     rows, D, st);
  return launch_ffn<float>(x, ctx, wout, bout, w1, b1, lns, lnb, w2, b2, out, rows, D,
                           st);
}

}  // extern "C"
