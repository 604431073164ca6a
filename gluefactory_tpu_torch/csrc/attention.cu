// LightGlue's training attention: packed self attention, bidirectional cross
// attention and the attention backward, as hand-written kernels.
//
// Replaces the Pallas kernels of gluefactory_tpu/ops/pallas_attention.py:
//   fused_attention_packed        (:421, body _attention_kernel_packed :319)
//     -> attn_fwd_kernel
//   fused_cross_attention_stacked (:779, call _bidir_cross_stacked_bnd :744)
//     -> cross_fwd_stacked_kernel
//   fused_cross_attention_packed  (:815, call _bidir_cross_packed_bnd :691)
//     -> cross_fwd_pair_kernel
//   _fused_attention_bwd_bhnd     (:202, body _attention_bwd_kernel :143)
//     -> attn_bwd_delta_kernel, attn_bwd_dkv_kernel, attn_bwd_dq_kernel
//
// The TPU bodies keep a whole K/V set in VMEM and carry the column softmax
// of the cross attention, and dk/dv of the backward, along a sequential
// grid axis. CUDA blocks have no order, so here:
//   - every forward is the online-softmax tile of attention_fwd.cuh on the
//     packed (S, N, H*64) layout (heads are channel strides, no transposes);
//     it also writes the per-row log-sum-exp (S, H, N) for the backward;
//   - the cross attention has a direction axis on the grid: direction d takes
//     its queries from set d and its keys and values from set 1 - d, so one
//     launch gives both message sets; sim is recomputed for the second
//     direction (the single-similarity form with merged column statistics is
//     a later optimisation);
//   - the backward is deterministic, with no atomics: a small pass computes
//     delta = rowsum(do * o); one kernel gridded over KEY tiles loops over
//     the query tiles and owns its dk/dv; one gridded over QUERY tiles loops
//     over the key tiles and owns its dq. Both rebuild
//     p = exp(scale * q.k - lse) from the saved log-sum-exp, then
//     dv = p^T do, dp = do v^T, ds = p (dp - delta) scale, dq = ds k,
//     dk = ds^T q. It takes separate query and key sets and masks, because
//     the cross backward calls it once a direction.
//
// Bound on the H100: at S = 64, N = 512, D = 256 the forward does 17 GFLOP
// on 134 MB of fp32 I/O and the backward 43 GFLOP on 235 MB: both are
// compute-bound against the fp32 rate (their inputs are fp32 in training).
// This first version computes in fp32 FMA on 4x4 register micro-tiles over
// 64x64 shared-memory tiles; tensor-core tiles are later work.
#include "attention_fwd.cuh"

namespace {

constexpr int kThreads = gf::kAttnThreads;
constexpr int kTile = gf::kAttnTile;
constexpr int kPad = gf::kAttnPad;
constexpr int kDh = gf::kAttnDh;

// ------------------------------------------------------------- forward
// K5. grid (ceil(Nq / 64), H, S): set s attends to itself.
template <class T>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mq, const unsigned char* __restrict__ mk,
    T* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int D, float scale) {
  GF_DYN_SMEM(float, smem);
  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const size_t qb = (size_t)s * Nq * D + h * kDh, kb = (size_t)s * Nk * D + h * kDh;
  gf::attn_fwd_tile<T>(q + qb, k + kb, v + kb, mq ? mq + (size_t)s * Nq : nullptr,
                       mk ? mk + (size_t)s * Nk : nullptr, out + qb,
                       lse + ((size_t)s * H + h) * Nq, Nq, Nk, D, blockIdx.x * kTile,
                       scale, smem);
}

// K6b. grid (ceil(N / 64), H, 2B): set s takes its keys and values from its
// partner (s + B) % 2B; out[s] holds the messages into set s.
template <class T>
__global__ void __launch_bounds__(kThreads) cross_fwd_stacked_kernel(
    const T* __restrict__ qk, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ lse, int B, int N, int D, float scale) {
  GF_DYN_SMEM(float, smem);
  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int o = (s + B) % (2 * B);
  const size_t qb = (size_t)s * N * D + h * kDh, kb = (size_t)o * N * D + h * kDh;
  gf::attn_fwd_tile<T>(qk + qb, qk + kb, v + kb, mask ? mask + (size_t)s * N : nullptr,
                       mask ? mask + (size_t)o * N : nullptr, out + qb,
                       lse + ((size_t)s * H + h) * N, N, N, D, blockIdx.x * kTile, scale,
                       smem);
}

// K6a. grid (ceil(max(M, N) / 64), H, 2B): z < B is direction 0 (queries of
// set 0, M rows, against set 1), z >= B direction 1.
template <class T>
__global__ void __launch_bounds__(kThreads) cross_fwd_pair_kernel(
    const T* __restrict__ qk0, const T* __restrict__ qk1, const T* __restrict__ v0,
    const T* __restrict__ v1, const unsigned char* __restrict__ mask0,
    const unsigned char* __restrict__ mask1, T* __restrict__ out0, T* __restrict__ out1,
    float* __restrict__ lse0, float* __restrict__ lse1, int B, int M, int N, int D,
    float scale) {
  GF_DYN_SMEM(float, smem);
  const int h = blockIdx.y, H = gridDim.y;
  const bool fwd = (int)blockIdx.z < B;
  const int b = fwd ? blockIdx.z : blockIdx.z - B;
  const int nq = fwd ? M : N, nk = fwd ? N : M;
  const int i0 = blockIdx.x * kTile;
  if (i0 >= nq) return;
  const size_t qb = (size_t)b * nq * D + h * kDh, kb = (size_t)b * nk * D + h * kDh;
  const unsigned char* mq = fwd ? mask0 : mask1;
  const unsigned char* mk = fwd ? mask1 : mask0;
  gf::attn_fwd_tile<T>((fwd ? qk0 : qk1) + qb, (fwd ? qk1 : qk0) + kb, (fwd ? v1 : v0) + kb,
                       mq ? mq + (size_t)b * nq : nullptr, mk ? mk + (size_t)b * nk : nullptr,
                       (fwd ? out0 : out1) + qb, (fwd ? lse0 : lse1) + ((size_t)b * H + h) * nq,
                       nq, nk, D, i0, scale, smem);
}

// ------------------------------------------------------------ backward
// delta[s, h, i] = sum_d do[s, i, h*64 + d] * o[s, i, h*64 + d]
template <class T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    int S, int Nq, int D, int H) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)S * H * Nq) return;
  const int i = idx % Nq, h = (idx / Nq) % H, s = idx / ((size_t)Nq * H);
  const size_t base = ((size_t)s * Nq + i) * D + h * kDh;
  float acc = 0.f;
  for (int d = 0; d < kDh; ++d) acc = fmaf(gf::to_f(o[base + d]), gf::to_f(dout[base + d]), acc);
  delta[idx] = acc;
}

// Five 64 x kPad tiles and three 64-vectors.
constexpr int kBwdSmem = (5 * kTile * kPad + 3 * kTile) * sizeof(float);

// Loads rows [r0, r0 + 64) of a packed head slice into dst[r][d] (row-major).
template <class T>
__device__ __forceinline__ void load_rows(float (*dst)[kPad], const T* __restrict__ src,
                                          int r0, int n, int ld) {
  for (int e = 0; e < kTile * kDh / kThreads; ++e) {
    int idx = threadIdx.x + e * kThreads;
    int r = idx / kDh, d = idx % kDh;
    dst[r][d] = r0 + r < n ? gf::to_f(src[(size_t)(r0 + r) * ld + d]) : 0.f;
  }
}

// The same rows transposed, dst[d][r].
template <class T>
__device__ __forceinline__ void load_rows_t(float (*dst)[kPad], const T* __restrict__ src,
                                            int r0, int n, int ld) {
  for (int e = 0; e < kTile * kDh / kThreads; ++e) {
    int idx = threadIdx.x + e * kThreads;
    int r = idx / kDh, d = idx % kDh;
    dst[d][r] = r0 + r < n ? gf::to_f(src[(size_t)(r0 + r) * ld + d]) : 0.f;
  }
}

// acc[r][c] += sum_t A[t][ty*4 + r] * B[t][tx*4 + c] over the 64 rows t.
__device__ __forceinline__ void mma_tn(float acc[4][4], float (*A)[kPad],
                                       float (*B)[kPad], int ty, int tx) {
#pragma unroll 8
  for (int t = 0; t < kTile; ++t) {
    float a[4], b[4];
    for (int r = 0; r < 4; ++r) a[r] = A[t][ty * 4 + r];
    for (int c = 0; c < 4; ++c) b[c] = B[t][tx * 4 + c];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// x[r][c] += sum_d A[ty*4 + r][d] * Bx[d][tx*4 + c], and the same for y with
// (Ay, By): the two 64-deep products that share their loop (sim and dp).
__device__ __forceinline__ void mma_nt2(float x[4][4], float y[4][4],
                                        float (*Ax)[kPad], float (*Bx)[kPad],
                                        float (*Ay)[kPad], float (*By)[kPad],
                                        int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < kDh; ++d) {
    float ax[4], bx[4], ay[4], by[4];
    for (int r = 0; r < 4; ++r) { ax[r] = Ax[ty * 4 + r][d]; ay[r] = Ay[ty * 4 + r][d]; }
    for (int c = 0; c < 4; ++c) { bx[c] = Bx[d][tx * 4 + c]; by[c] = By[d][tx * 4 + c]; }
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        x[r][c] = fmaf(ax[r], bx[c], x[r][c]);
        y[r][c] = fmaf(ay[r], by[c], y[r][c]);
      }
  }
}

// grid (ceil(Nk / 64), H, S). The block owns key tile j0 and its dk, dv; it
// loops over the query tiles. Threads hold sim/dp as (query ty, key tx) and
// dk/dv as (key ty, channel tx).
template <class T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mq,
    const unsigned char* __restrict__ mk, T* __restrict__ dk, T* __restrict__ dv,
    int Nq, int Nk, int D, float scale) {
  GF_DYN_SMEM(float, smem);
  float(*KsT)[kPad] = reinterpret_cast<float(*)[kPad]>(smem);                     // [d][j]
  float(*VsT)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + kTile * kPad);      // [d][j]
  float(*Qs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 2 * kTile * kPad);   // [i][d]
  float(*dOs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 3 * kTile * kPad);  // [i][d]
  float(*Ps)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 4 * kTile * kPad);   // [i][j]
  float* rowl = smem + 5 * kTile * kPad;  // lse of the query rows
  float* rowd = rowl + kTile;             // delta of the query rows
  float* rowv = rowd + kTile;             // validity of the query rows

  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y, j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qb = (size_t)s * Nq * D + h * kDh, kb = (size_t)s * Nk * D + h * kDh;
  const size_t rb = ((size_t)s * H + h) * Nq;

  load_rows_t<T>(KsT, k + kb, j0, Nk, D);
  load_rows_t<T>(VsT, v + kb, j0, Nk, D);
  bool kv[4];
  for (int c = 0; c < 4; ++c) {
    int gj = j0 + tx * 4 + c;
    kv[c] = gj < Nk && (mk == nullptr || mk[(size_t)s * Nk + gj]);
  }

  float dka[4][4] = {}, dva[4][4] = {};
  for (int i0 = 0; i0 < Nq; i0 += kTile) {
    __syncthreads();
    load_rows<T>(Qs, q + qb, i0, Nq, D);
    load_rows<T>(dOs, dout + qb, i0, Nq, D);
    if (tid < kTile) {
      int gi = i0 + tid;
      bool in = gi < Nq;
      rowl[tid] = in ? lse[rb + gi] : 0.f;
      rowd[tid] = in ? delta[rb + gi] : 0.f;
      rowv[tid] = (in && (mq == nullptr || mq[(size_t)s * Nq + gi])) ? 1.f : 0.f;
    }
    __syncthreads();

    float sim[4][4] = {}, dp[4][4] = {};
    mma_nt2(sim, dp, Qs, KsT, dOs, VsT, ty, tx);
    for (int r = 0; r < 4; ++r) {
      int i = ty * 4 + r;
      bool qv = rowv[i] > 0.f;
      for (int c = 0; c < 4; ++c) {
        float p = (qv && kv[c]) ? expf(sim[r][c] * scale - rowl[i]) : 0.f;
        Ps[i][tx * 4 + c] = p;
        sim[r][c] = p * (dp[r][c] - rowd[i]) * scale;  // ds
      }
    }
    __syncthreads();
    mma_tn(dva, Ps, dOs, ty, tx);  // dv[j][d] += sum_i p[i][j] do[i][d]
    __syncthreads();
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) Ps[ty * 4 + r][tx * 4 + c] = sim[r][c];
    __syncthreads();
    mma_tn(dka, Ps, Qs, ty, tx);  // dk[j][d] += sum_i ds[i][j] q[i][d]
  }

  for (int r = 0; r < 4; ++r) {
    int gj = j0 + ty * 4 + r;
    if (gj >= Nk) continue;
    for (int c = 0; c < 4; ++c) {
      size_t at = kb + (size_t)gj * D + tx * 4 + c;
      dk[at] = gf::from_f<T>(dka[r][c]);
      dv[at] = gf::from_f<T>(dva[r][c]);
    }
  }
}

// grid (ceil(Nq / 64), H, S). The block owns query tile i0 and its dq; it
// loops over the key tiles. Threads hold sim^T/dp^T as (key ty, query tx)
// and dq as (query ty, channel tx).
template <class T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mq,
    const unsigned char* __restrict__ mk, T* __restrict__ dq,
    int Nq, int Nk, int D, float scale) {
  GF_DYN_SMEM(float, smem);
  float(*QsT)[kPad] = reinterpret_cast<float(*)[kPad]>(smem);                      // [d][i]
  float(*dOsT)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + kTile * kPad);      // [d][i]
  float(*Ks)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 2 * kTile * kPad);    // [j][d]
  float(*Vs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 3 * kTile * kPad);    // [j][d]
  float(*Ss)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 4 * kTile * kPad);    // [j][i]
  float* kvalid = smem + 5 * kTile * kPad;

  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y, i0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qb = (size_t)s * Nq * D + h * kDh, kb = (size_t)s * Nk * D + h * kDh;
  const size_t rb = ((size_t)s * H + h) * Nq;

  load_rows_t<T>(QsT, q + qb, i0, Nq, D);
  load_rows_t<T>(dOsT, dout + qb, i0, Nq, D);
  bool qv[4];
  float rl[4], rd[4];
  for (int c = 0; c < 4; ++c) {
    int gi = i0 + tx * 4 + c;
    bool in = gi < Nq;
    qv[c] = in && (mq == nullptr || mq[(size_t)s * Nq + gi]);
    rl[c] = in ? lse[rb + gi] : 0.f;
    rd[c] = in ? delta[rb + gi] : 0.f;
  }

  float dqa[4][4] = {};
  for (int j0 = 0; j0 < Nk; j0 += kTile) {
    __syncthreads();
    load_rows<T>(Ks, k + kb, j0, Nk, D);
    load_rows<T>(Vs, v + kb, j0, Nk, D);
    if (tid < kTile) {
      int gj = j0 + tid;
      kvalid[tid] = (gj < Nk && (mk == nullptr || mk[(size_t)s * Nk + gj])) ? 1.f : 0.f;
    }
    __syncthreads();

    float sim[4][4] = {}, dp[4][4] = {};
    mma_nt2(sim, dp, Ks, QsT, Vs, dOsT, ty, tx);
    for (int r = 0; r < 4; ++r) {
      bool kvr = kvalid[ty * 4 + r] > 0.f;
      for (int c = 0; c < 4; ++c) {
        float p = (kvr && qv[c]) ? expf(sim[r][c] * scale - rl[c]) : 0.f;
        Ss[ty * 4 + r][tx * 4 + c] = p * (dp[r][c] - rd[c]) * scale;
      }
    }
    __syncthreads();
    mma_tn(dqa, Ss, Ks, ty, tx);  // dq[i][d] += sum_j ds[j][i] k[j][d]
  }

  for (int r = 0; r < 4; ++r) {
    int gi = i0 + ty * 4 + r;
    if (gi >= Nq) continue;
    for (int c = 0; c < 4; ++c)
      dq[qb + (size_t)gi * D + tx * 4 + c] = gf::from_f<T>(dqa[r][c]);
  }
}

// ------------------------------------------------------------ launchers
template <class T>
int launch_attn_fwd(const void* q, const void* k, const void* v, const unsigned char* mq,
                    const unsigned char* mk, void* out, float* lse, int S, int Nq, int Nk,
                    int D, int H, float scale, cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(attn_fwd_kernel<T>, gf::kAttnFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Nq + kTile - 1) / kTile, H, S);
  GF_LAUNCH(attn_fwd_kernel<T>, grid, kThreads, gf::kAttnFwdSmem, st, (const T*)q,
            (const T*)k, (const T*)v, mq, mk, (T*)out, lse, Nq, Nk, D, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_cross_stacked(const void* qk, const void* v, const unsigned char* mask, void* out,
                         float* lse, int B, int N, int D, int H, float scale,
                         cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(cross_fwd_stacked_kernel<T>, gf::kAttnFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + kTile - 1) / kTile, H, 2 * B);
  GF_LAUNCH(cross_fwd_stacked_kernel<T>, grid, kThreads, gf::kAttnFwdSmem, st,
            (const T*)qk, (const T*)v, mask, (T*)out, lse, B, N, D, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_cross_pair(const void* qk0, const void* qk1, const void* v0, const void* v1,
                      const unsigned char* mask0, const unsigned char* mask1, void* out0,
                      void* out1, float* lse0, float* lse1, int B, int M, int N, int D,
                      int H, float scale, cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(cross_fwd_pair_kernel<T>, gf::kAttnFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int longer = M > N ? M : N;
  dim3 grid((longer + kTile - 1) / kTile, H, 2 * B);
  GF_LAUNCH(cross_fwd_pair_kernel<T>, grid, kThreads, gf::kAttnFwdSmem, st, (const T*)qk0,
            (const T*)qk1, (const T*)v0, (const T*)v1, mask0, mask1, (T*)out0, (T*)out1,
            lse0, lse1, B, M, N, D, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, const unsigned char* mq,
                    const unsigned char* mk, float* delta, void* dq, void* dk, void* dv,
                    int S, int Nq, int Nk, int D, int H, float scale, cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr_kv = gf::allow_smem(attn_bwd_dkv_kernel<T>, kBwdSmem);
  static cudaError_t attr_q = gf::allow_smem(attn_bwd_dq_kernel<T>, kBwdSmem);
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  if (attr_q != cudaSuccess) return (int)attr_q;
  const size_t rows = (size_t)S * H * Nq;
  GF_LAUNCH(attn_bwd_delta_kernel<T>, dim3((unsigned)((rows + kThreads - 1) / kThreads)),
            kThreads, 0, st, (const T*)o, (const T*)dout, delta, S, Nq, D, H);
  GF_LAUNCH(attn_bwd_dkv_kernel<T>, dim3((Nk + kTile - 1) / kTile, H, S), kThreads, kBwdSmem,
            st, (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
            (const float*)delta, mq, mk, (T*)dk, (T*)dv, Nq, Nk, D, scale);
  GF_LAUNCH(attn_bwd_dq_kernel<T>, dim3((Nq + kTile - 1) / kTile, H, S), kThreads, kBwdSmem,
            st, (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
            (const float*)delta, mq, mk, (T*)dq, Nq, Nk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int at_attn_fwd(const void* q, const void* k, const void* v, const void* mq, const void* mk,
                void* out, void* lse, int S, int Nq, int Nk, int D, int H, float scale,
                int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto a = (const unsigned char*)mq, b = (const unsigned char*)mk;
  if (dtype == gf::kBF16)
    return launch_attn_fwd<__nv_bfloat16>(q, k, v, a, b, out, (float*)lse, S, Nq, Nk, D, H,
                                          scale, st);
  return launch_attn_fwd<float>(q, k, v, a, b, out, (float*)lse, S, Nq, Nk, D, H, scale, st);
}

int at_cross_fwd_stacked(const void* qk, const void* v, const void* mask, void* out,
                         void* lse, int B, int N, int D, int H, float scale, int dtype,
                         void* stream) {
  auto st = (cudaStream_t)stream;
  auto mk = (const unsigned char*)mask;
  if (dtype == gf::kBF16)
    return launch_cross_stacked<__nv_bfloat16>(qk, v, mk, out, (float*)lse, B, N, D, H,
                                               scale, st);
  return launch_cross_stacked<float>(qk, v, mk, out, (float*)lse, B, N, D, H, scale, st);
}

int at_cross_fwd_pair(const void* qk0, const void* qk1, const void* v0, const void* v1,
                      const void* mask0, const void* mask1, void* out0, void* out1,
                      void* lse0, void* lse1, int B, int M, int N, int D, int H,
                      float scale, int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto a = (const unsigned char*)mask0, b = (const unsigned char*)mask1;
  if (dtype == gf::kBF16)
    return launch_cross_pair<__nv_bfloat16>(qk0, qk1, v0, v1, a, b, out0, out1, (float*)lse0,
                                            (float*)lse1, B, M, N, D, H, scale, st);
  return launch_cross_pair<float>(qk0, qk1, v0, v1, a, b, out0, out1, (float*)lse0,
                                  (float*)lse1, B, M, N, D, H, scale, st);
}

int at_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const void* lse, const void* mq, const void* mk, void* delta, void* dq,
                void* dk, void* dv, int S, int Nq, int Nk, int D, int H, float scale,
                int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto a = (const unsigned char*)mq, b = (const unsigned char*)mk;
  if (dtype == gf::kBF16)
    return launch_attn_bwd<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, a, b,
                                          (float*)delta, dq, dk, dv, S, Nq, Nk, D, H, scale,
                                          st);
  return launch_attn_bwd<float>(q, k, v, o, dout, (const float*)lse, a, b, (float*)delta, dq,
                                dk, dv, S, Nq, Nk, D, H, scale, st);
}

}  // extern "C"
