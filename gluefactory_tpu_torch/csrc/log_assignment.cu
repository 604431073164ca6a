// Fused LightGlue log assignment: sigmoid log double-softmax with dustbins,
// plus the row and column max / first-index argmax that match filtering
// needs, without materialising sim.
//
// Replaces fused_log_assignment in gluefactory_tpu/ops/pallas_assignment.py
// (:271; _stats_kernel :46, _write_kernel :93, pallas_call sites :200 and
// :225). The TPU kernels carry the column log-sum-exp and the column
// max/argmax along a sequential grid axis (:73-90, :136-152). Hopper blocks
// run in no order, so the work becomes four launches of two kernels:
//   1. lse_rows_kernel(mdesc0, mdesc1)  -> row log-sum-exp of masked sim;
//   2. lse_rows_kernel(mdesc1, mdesc0)  -> column log-sum-exp, sim recomputed
//      as mdesc1 . mdesc0^T;
//   3. assign_rows_kernel(mdesc0, mdesc1, write) -> the (B, M+1, N+1) matrix
//      with logsigmoid(-z) dustbins and -1e9 padding, plus row max/argmax;
//   4. assign_rows_kernel(mdesc1, mdesc0, no write) -> column max/argmax.
// Each inner entry is 2*sim + (ls(z0_i) - lse0_i) + (ls(z1_j) - lse1_j); the
// swapped launches sum the same products in the same order and add the two
// certainties commutatively, so they see bit-identical entries and the
// column argmax agrees with the written matrix, ties resolved to the first
// index like jnp.argmax.
//
// Bound on the H100: at B = 8, M = N = 1024, D = 256 the four launches do
// ~8.6 GFLOP of sim recomputation (two passes' worth of the matrix for the
// bound, 2*B*M*N*D each) and must write 8*1025^2*4 B = 33.6 MB, so the
// bound is the write at ~10 us. This first version computes sim with fp32
// FMA over 64x64 shared-memory tiles (the 67 TFLOP/s fp32 rate, ~0.13 ms for
// the four sim passes) and writes the matrix once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kKc = 32;
constexpr int kPad = 68;

// sim[i][j] = a[row0 + ty*4 + i] . b[col0 + tx*4 + j] over D (rows past the
// end read as zero).
__device__ void sim_tile(const float* __restrict__ a, int rows_a, int row0,
                         const float* __restrict__ b, int rows_b, int col0, int D,
                         float sim[4][4], float (*As)[kPad], float (*Bs)[kPad]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) sim[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kKc) {
    for (int e = 0; e < kTile * kKc / kThreads; ++e) {
      int idx = tid + e * kThreads;
      int r = idx / kKc, kk = idx % kKc;
      int ga = row0 + r, gb = col0 + r;
      As[kk][r] = ga < rows_a ? a[(size_t)ga * D + k0 + kk] : 0.f;
      Bs[kk][r] = gb < rows_b ? b[(size_t)gb * D + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKc; ++kk) {
      float x[4], y[4];
      for (int i = 0; i < 4; ++i) x[i] = As[kk][ty * 4 + i];
      for (int j = 0; j < 4; ++j) y[j] = Bs[kk][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) sim[i][j] = fmaf(x[i], y[j], sim[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool valid_at(const unsigned char* mask, size_t base, int i,
                                         int n) {
  return i < n && (mask == nullptr || mask[base + i]);
}

// grid (ceil(M / 64), B): lse[b, i] = log sum_j exp(sim_ij) over valid pairs.
__global__ void __launch_bounds__(kThreads) lse_rows_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const unsigned char* __restrict__ mask_a, const unsigned char* __restrict__ mask_b,
    float* __restrict__ lse, int M, int N, int D) {
  __shared__ float As[kKc][kPad], Bs[kKc][kPad];
  __shared__ float red[kTile][17];
  const int bi = blockIdx.y, row0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* ab = a + (size_t)bi * M * D;
  const float* bb = b + (size_t)bi * N * D;
  bool va[4];
  float m[4], l[4];
  for (int i = 0; i < 4; ++i) {
    va[i] = valid_at(mask_a, (size_t)bi * M, row0 + ty * 4 + i, M);
    m[i] = gf::kNeg;
    l[i] = 0.f;
  }
  for (int col0 = 0; col0 < N; col0 += kTile) {
    float sim[4][4];
    sim_tile(ab, M, row0, bb, N, col0, D, sim, As, Bs);
    bool vb[4];
    for (int j = 0; j < 4; ++j) vb[j] = valid_at(mask_b, (size_t)bi * N, col0 + tx * 4 + j, N);
    for (int i = 0; i < 4; ++i) {
      float pm = gf::kNeg;
      for (int j = 0; j < 4; ++j)
        if (va[i] && vb[j]) pm = fmaxf(pm, sim[i][j]);
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
      for (int j = 0; j < 4; ++j)
        if (va[i] && vb[j]) ps += expf(sim[i][j] - mnew[i]);
      red[ty * 4 + i][tx] = ps;
    }
    __syncthreads();
    for (int i = 0; i < 4; ++i) {
      float ls = 0.f;
      for (int t = 0; t < 16; ++t) ls += red[ty * 4 + i][t];
      l[i] = l[i] * expf(m[i] - mnew[i]) + ls;
      m[i] = mnew[i];
    }
    __syncthreads();
  }
  if (tx == 0)
    for (int i = 0; i < 4; ++i) {
      int r = row0 + ty * 4 + i;
      if (r < M) lse[(size_t)bi * M + r] = logf(fmaxf(l[i], 1e-30f)) + m[i];
    }
}

// grid (ceil(rows / 64), B) with rows = M + 1 when writing (the last row is
// the dustbin row), else M. Row max / first-index argmax of the inner
// (M, N) block go to rmax / rarg.
__global__ void __launch_bounds__(kThreads) assign_rows_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ za, const float* __restrict__ zb,
    const float* __restrict__ lse_a, const float* __restrict__ lse_b,
    const unsigned char* __restrict__ mask_a, const unsigned char* __restrict__ mask_b,
    float* __restrict__ out, float* __restrict__ rmax, int* __restrict__ rarg,
    int M, int N, int D) {
  __shared__ float As[kKc][kPad], Bs[kKc][kPad];
  __shared__ float redv[kTile][17];
  __shared__ int redi[kTile][17];
  const int bi = blockIdx.y, row0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* ab = a + (size_t)bi * M * D;
  const float* bb = b + (size_t)bi * N * D;
  const size_t ma = (size_t)bi * M, nb = (size_t)bi * N;
  float* ob = out == nullptr ? nullptr : out + (size_t)bi * (M + 1) * (N + 1);

  bool va[4];
  float ca[4], best[4];
  int arg[4];
  for (int i = 0; i < 4; ++i) {
    int r = row0 + ty * 4 + i;
    va[i] = valid_at(mask_a, ma, r, M);
    ca[i] = r < M ? gf::log_sigmoid(za[ma + r]) - lse_a[ma + r] : 0.f;
    best[i] = -INFINITY;
    arg[i] = 0;
  }
  for (int col0 = 0; col0 < N; col0 += kTile) {
    float sim[4][4];
    sim_tile(ab, M, row0, bb, N, col0, D, sim, As, Bs);
    for (int j = 0; j < 4; ++j) {
      int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      bool vb = valid_at(mask_b, nb, c, N);
      float cb = gf::log_sigmoid(zb[nb + c]) - lse_b[nb + c];
      for (int i = 0; i < 4; ++i) {
        int r = row0 + ty * 4 + i;
        float v = (va[i] && vb) ? 2.f * sim[i][j] + (ca[i] + cb) : gf::kNeg;
        if (v > best[i]) {
          best[i] = v;
          arg[i] = c;
        }
        if (ob != nullptr && r < M) ob[(size_t)r * (N + 1) + c] = v;
        if (ob != nullptr && r == M) ob[(size_t)r * (N + 1) + c] = vb ? gf::log_sigmoid(-zb[nb + c]) : gf::kNeg;
      }
    }
  }
  if (ob != nullptr && tx == 0)
    for (int i = 0; i < 4; ++i) {
      int r = row0 + ty * 4 + i;
      if (r < M) ob[(size_t)r * (N + 1) + N] = va[i] ? gf::log_sigmoid(-za[ma + r]) : gf::kNeg;
      if (r == M) ob[(size_t)r * (N + 1) + N] = 0.f;
    }
  for (int i = 0; i < 4; ++i) {
    redv[ty * 4 + i][tx] = best[i];
    redi[ty * 4 + i][tx] = arg[i];
  }
  __syncthreads();
  if (tx == 0)
    for (int i = 0; i < 4; ++i) {
      int r = row0 + ty * 4 + i;
      if (r >= M) continue;
      float bv = redv[ty * 4 + i][0];
      int bidx = redi[ty * 4 + i][0];
      for (int t = 1; t < 16; ++t) {
        float v = redv[ty * 4 + i][t];
        int id = redi[ty * 4 + i][t];
        if (v > bv || (v == bv && id < bidx)) {
          bv = v;
          bidx = id;
        }
      }
      rmax[ma + r] = bv;
      rarg[ma + r] = bidx;
    }
}

}  // namespace

extern "C" {

int la_lse_rows(const void* a, const void* b, const void* mask_a, const void* mask_b,
                void* lse, int B, int M, int N, int D, void* stream) {
  if (D % kKc) return (int)cudaErrorInvalidValue;
  dim3 grid((M + kTile - 1) / kTile, B);
  GF_LAUNCH(lse_rows_kernel, grid, kThreads, 0, (cudaStream_t)stream, (const float*)a,
            (const float*)b, (const unsigned char*)mask_a,
            (const unsigned char*)mask_b, (float*)lse, M, N, D);
  return (int)cudaGetLastError();
}

int la_assign_rows(const void* a, const void* b, const void* za, const void* zb,
                   const void* lse_a, const void* lse_b, const void* mask_a,
                   const void* mask_b, void* out, void* rmax, void* rarg, int B, int M,
                   int N, int D, void* stream) {
  if (D % kKc) return (int)cudaErrorInvalidValue;
  int rows = out == nullptr ? M : M + 1;
  dim3 grid((rows + kTile - 1) / kTile, B);
  GF_LAUNCH(assign_rows_kernel, grid, kThreads, 0, (cudaStream_t)stream,
            (const float*)a, (const float*)b, (const float*)za, (const float*)zb,
            (const float*)lse_a, (const float*)lse_b, (const unsigned char*)mask_a,
            (const unsigned char*)mask_b, (float*)out, (float*)rmax, (int*)rarg, M,
            N, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
