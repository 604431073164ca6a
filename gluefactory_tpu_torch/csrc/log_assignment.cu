// Fused LightGlue log assignment: sigmoid log double-softmax with dustbins,
// plus the row and column max / first-index argmax that match filtering
// needs.
//
// Replaces fused_log_assignment in gluefactory_tpu/ops/pallas_assignment.py
// (:271; _stats_kernel :46, _write_kernel :93, pallas_call sites :200 and
// :225). The TPU kernels carry the column log-sum-exp and the column
// max/argmax along a sequential grid axis (:73-90, :136-152). Hopper blocks
// run in no order, so the work becomes four launches over 64 x 64 tiles of
// the (M, N) block, each tile's statistics written to a small scratch and
// merged in tile order:
//   1. sim_kernel: sim = mdesc0 . mdesc1^T on the tensor cores, written into
//      the inner (M, N) block of the output, and the tile's masked (max,
//      sum of exp) of each row over its 64 columns and of each column over
//      its 64 rows;
//   2. lse_kernel: the partials of each row and column merged into its
//      log-sum-exp, and the certainties c0_i = ls(z0_i) - lse0_i and
//      c1_j = ls(z1_j) - lse1_j;
//   3. finish_kernel: one elementwise pass over the matrix, sim to
//      2*sim + (c0_i + c1_j) (-1e9 where the pair is masked), the dustbin
//      row and column, and the tile's max / first argmax of each row and
//      column of what it wrote;
//   4. argmax_kernel: those partials merged into (rowmax, rowarg, colmax,
//      colarg).
// The product is computed once: recomputing it for the column statistics
// or the written matrix would cost a product's operations each, where
// re-reading sim once from the output costs 67 MB of traffic (~0.02 ms at
// b8). The column statistics
// read the same stored entries as the rows, so the column argmax agrees with
// the written matrix; ties go to the first index, as in jnp.argmax. No
// atomics: two calls give bit-identical outputs.
//
// Bound on the H100: at B = 8, M = N = 1024, D = 256 sim is 4.3 GFLOP and
// the matrix 8*1025^2*4 B = 33.6 MB. The product runs on mma.sync m16n8k8 at
// fp32 accuracy (operands split into TF32 hi and lo, three passes; 165
// TFLOP/s at best, ~0.026 ms), 4 warps of 16 x 64 a tile over 32-deep stages
// of A and B in a three-stage cp.async ring (55 KB, four blocks a
// multiprocessor). A tile is staged in shared memory at row stride 65 for
// its statistics (a thread a row or a column, conflict-free either way) and
// its coalesced stores: neighbouring threads write neighbouring floats.
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;           // 4 warps
constexpr int kT = 64;                  // rows and columns of a tile
constexpr int kKc = 32;                 // depth of a product stage
constexpr int kKs = kKc + 4;            // row stride of a stage's tiles (144 B)
constexpr int kStages = 3;
constexpr int kStageF = 2 * kT * kKs;   // floats of a stage: A then B
constexpr int kTs = kT + 1;             // row stride of a staged 64 x 64 tile
constexpr int kSimSmem = kStages * kStageF * (int)sizeof(float);  // 55,296 B
static_assert(kT * kTs <= kStages * kStageF, "the staged tile reuses the ring");

__device__ __forceinline__ bool valid_at(const unsigned char* mask, size_t base, int i,
                                         int n) {
  return i < n && (mask == nullptr || mask[base + i]);
}

// Scratch (floats), with nrt = ceil(M / 64), nct = ceil(N / 64):
//   rs, rt   (B, nct, M)  row partials of column tile ct: (max, sum of exp)
//                         for lse_kernel, then (max, argmax) for argmax_kernel
//   cs, ct   (B, nrt, N)  column partials of row tile rt, alike
//   c0, c1   (B, M), (B, N)  the certainties
struct Scratch {
  float *rs, *rt, *cs, *ct, *c0, *c1;
};

inline Scratch carve(float* base, int B, int M, int N) {
  const size_t nrt = (M + kT - 1) / kT, nct = (N + kT - 1) / kT;
  const size_t r = (size_t)B * nct * M, c = (size_t)B * nrt * N;
  return Scratch{base, base + r, base + 2 * r, base + 2 * r + c, base + 2 * r + 2 * c,
                 base + 2 * r + 2 * c + (size_t)B * M};
}

// The validity of the rows (rv) and columns (cv) of this block's tile (row
// tile blockIdx.y, column tile blockIdx.x, batch blockIdx.z); false past M, N.
__device__ __forceinline__ void tile_masks(const unsigned char* mask_a,
                                           const unsigned char* mask_b, int M, int N,
                                           bool* rv, bool* cv) {
  const int tid = threadIdx.x, bi = blockIdx.z;
  if (tid < kT) {
    rv[tid] = valid_at(mask_a, (size_t)bi * M, blockIdx.y * kT + tid, M);
    cv[tid] = valid_at(mask_b, (size_t)bi * N, blockIdx.x * kT + tid, N);
  }
}

// grid (ceil(N / 64), ceil(M / 64), B)
__global__ void __launch_bounds__(kThreads) sim_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const unsigned char* __restrict__ mask_a, const unsigned char* __restrict__ mask_b,
    float* __restrict__ out, Scratch sc, int M, int N, int D) {
  GF_DYN_SMEM(float, smem);
  __shared__ bool rv[kT], cv[kT];
  const int bi = blockIdx.z, row0 = blockIdx.y * kT, col0 = blockIdx.x * kT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = warp * 16;
  const float* ab = a + (size_t)bi * M * D;
  const float* bb = b + (size_t)bi * N * D;
  tile_masks(mask_a, mask_b, M, N, rv, cv);

  auto load = [&](int stage, int k0) {
    float* As = smem + stage * kStageF;
    float* Bs = As + kT * kKs;
    for (int e = tid; e < kT * kKc / 4; e += kThreads) {
      const int r = e / (kKc / 4), c = e % (kKc / 4) * 4;
      const bool ina = row0 + r < M, inb = col0 + r < N;
      gf::cp_async16(As + r * kKs + c, ab + (size_t)(ina ? row0 + r : 0) * D + k0 + c, ina);
      gf::cp_async16(Bs + r * kKs + c, bb + (size_t)(inb ? col0 + r : 0) * D + k0 + c, inb);
    }
  };

  float acc[8][4] = {};  // (row m0 + g (+8), column 8ni + 2t (+1))
  const int nk = D / kKc;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st * kKc);
    gf::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gf::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int pf = kt + kStages - 1;
    if (pf < nk) load(pf % kStages, pf * kKc);
    gf::cp_async_commit();
    const float* As = smem + (kt % kStages) * kStageF;
    const float* Bs = As + kT * kKs;
#pragma unroll
    for (int ks = 0; ks < kKc / 8; ++ks) {
      unsigned ah[4], al[4];
      gf::frag_a<kKs>(ah, al, As, m0, 8 * ks);
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        unsigned bh[4], bl[4];
        gf::frag_b_rows<kKs>(bh, bl, Bs, 8 * ni, 8 * ks);
        gf::mma_tf32x3(acc[ni], ah, al, bh, bl);
        gf::mma_tf32x3(acc[ni + 1], ah, al, bh + 2, bl + 2);
      }
    }
  }
  gf::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the tile takes its place
  float* Ts = smem;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Ts[(m0 + g + 8 * (e >> 1)) * kTs + 8 * ni + 2 * t + (e & 1)] = acc[ni][e];
  __syncthreads();

  float* ob = out + (size_t)bi * (M + 1) * (N + 1);
  for (int r = warp; r < kT && row0 + r < M; r += kThreads / 32)
    for (int c = lane; c < kT && col0 + c < N; c += 32)
      ob[(size_t)(row0 + r) * (N + 1) + col0 + c] = Ts[r * kTs + c];

  // masked (max, sum of exp): threads 0..63 a column over the tile's rows,
  // 64..127 a row over its columns
  const bool col = tid < kT;
  const int x = col ? tid : tid - kT;
  const float* p = col ? Ts + x : Ts + x * kTs;
  const int step = col ? kTs : 1;
  const bool* other = col ? rv : cv;
  float mx = gf::kNeg, s = 0.f;
  if (col ? cv[x] : rv[x]) {
    for (int y = 0; y < kT; ++y)
      if (other[y]) mx = fmaxf(mx, p[y * step]);
    for (int y = 0; y < kT; ++y)
      if (other[y]) s += expf(p[y * step] - mx);
  }
  if (col && col0 + x < N) {
    const size_t at = ((size_t)bi * gridDim.y + blockIdx.y) * N + col0 + x;
    sc.cs[at] = mx;
    sc.ct[at] = s;
  } else if (!col && row0 + x < M) {
    const size_t at = ((size_t)bi * gridDim.x + blockIdx.x) * M + row0 + x;
    sc.rs[at] = mx;
    sc.rt[at] = s;
  }
}

// grid (ceil((M + N) / 128), B): thread x merges the partials of row x < M,
// or of column x - M, in tile order into its log-sum-exp and certainty.
__global__ void __launch_bounds__(kThreads) lse_kernel(
    const float* __restrict__ za, const float* __restrict__ zb, Scratch sc, int M, int N) {
  const int bi = blockIdx.y, x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= M + N) return;
  const bool row = x < M;
  const int n = row ? M : N, i = row ? x : x - M;
  const int parts = row ? (N + kT - 1) / kT : (M + kT - 1) / kT;
  const size_t at = (size_t)bi * parts * n + i;
  const float* pm = (row ? sc.rs : sc.cs) + at;
  const float* ps = (row ? sc.rt : sc.ct) + at;
  float mx = gf::kNeg, s = 0.f;
  for (int q = 0; q < parts; ++q) mx = fmaxf(mx, pm[(size_t)q * n]);
  for (int q = 0; q < parts; ++q) s += ps[(size_t)q * n] * expf(pm[(size_t)q * n] - mx);
  const float lse = logf(fmaxf(s, 1e-30f)) + mx;
  const size_t zi = (size_t)bi * n + i;
  (row ? sc.c0 : sc.c1)[zi] = gf::log_sigmoid((row ? za : zb)[zi]) - lse;
}

// grid (ceil(N / 64), ceil(M / 64), B)
__global__ void __launch_bounds__(kThreads) finish_kernel(
    const float* __restrict__ za, const float* __restrict__ zb,
    const unsigned char* __restrict__ mask_a, const unsigned char* __restrict__ mask_b,
    float* __restrict__ out, Scratch sc, int M, int N) {
  __shared__ float Ts[kT * kTs];
  __shared__ float ca[kT], cb[kT];
  __shared__ bool rv[kT], cv[kT];
  const int bi = blockIdx.z, row0 = blockIdx.y * kT, col0 = blockIdx.x * kT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ob = out + (size_t)bi * (M + 1) * (N + 1);
  tile_masks(mask_a, mask_b, M, N, rv, cv);
  if (tid < kT) {
    const int i = row0 + tid, j = col0 + tid;
    ca[tid] = i < M ? sc.c0[(size_t)bi * M + i] : 0.f;
    cb[tid] = j < N ? sc.c1[(size_t)bi * N + j] : 0.f;
    // the dustbin column (blocks of the first column tile) and row (of the
    // first row tile), and the corner
    if (blockIdx.x == 0 && i < M)
      ob[(size_t)i * (N + 1) + N] = rv[tid] ? gf::log_sigmoid(-za[(size_t)bi * M + i]) : gf::kNeg;
    if (blockIdx.y == 0 && j < N)
      ob[(size_t)M * (N + 1) + j] = cv[tid] ? gf::log_sigmoid(-zb[(size_t)bi * N + j]) : gf::kNeg;
    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) ob[(size_t)M * (N + 1) + N] = 0.f;
  }
  __syncthreads();
  for (int r = warp; r < kT && row0 + r < M; r += kThreads / 32)
    for (int c = lane; c < kT && col0 + c < N; c += 32) {
      float* at = ob + (size_t)(row0 + r) * (N + 1) + col0 + c;
      const float v = rv[r] && cv[c] ? 2.f * *at + (ca[r] + cb[c]) : gf::kNeg;
      *at = v;
      Ts[r * kTs + c] = v;
    }
  __syncthreads();

  // max and first argmax of what was written: threads 0..63 a column,
  // 64..127 a row
  const bool col = tid < kT;
  const int x = col ? tid : tid - kT;
  const int left = col ? M - row0 : N - col0, len = left < kT ? left : kT;
  const int first = col ? row0 : col0;
  const float* p = col ? Ts + x : Ts + x * kTs;
  const int step = col ? kTs : 1;
  float best = -INFINITY;
  int arg = first;
  for (int y = 0; y < len; ++y) {
    const float v = p[y * step];
    if (v > best) {
      best = v;
      arg = first + y;
    }
  }
  if (col && col0 + x < N) {
    const size_t at = ((size_t)bi * gridDim.y + blockIdx.y) * N + col0 + x;
    sc.cs[at] = best;
    reinterpret_cast<int*>(sc.ct)[at] = arg;
  } else if (!col && row0 + x < M) {
    const size_t at = ((size_t)bi * gridDim.x + blockIdx.x) * M + row0 + x;
    sc.rs[at] = best;
    reinterpret_cast<int*>(sc.rt)[at] = arg;
  }
}

// grid (ceil((M + N) / 128), B): the tiles' (max, argmax) of row x < M, or
// of column x - M, merged in tile order (a later tile wins only if larger).
__global__ void __launch_bounds__(kThreads) argmax_kernel(
    Scratch sc, float* __restrict__ rmax, int* __restrict__ rarg, float* __restrict__ cmax,
    int* __restrict__ carg, int M, int N) {
  const int bi = blockIdx.y, x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= M + N) return;
  const bool row = x < M;
  const int n = row ? M : N, i = row ? x : x - M;
  const int parts = row ? (N + kT - 1) / kT : (M + kT - 1) / kT;
  const size_t at = (size_t)bi * parts * n + i;
  const float* pm = (row ? sc.rs : sc.cs) + at;
  const int* pa = reinterpret_cast<const int*>(row ? sc.rt : sc.ct) + at;
  float best = pm[0];
  int arg = pa[0];
  for (int q = 1; q < parts; ++q)
    if (pm[(size_t)q * n] > best) {
      best = pm[(size_t)q * n];
      arg = pa[(size_t)q * n];
    }
  (row ? rmax : cmax)[(size_t)bi * n + i] = best;
  (row ? rarg : carg)[(size_t)bi * n + i] = arg;
}

}  // namespace

extern "C" {

// scores (B, M+1, N+1), rmax / rarg (B, M), cmax / carg (B, N); a, b
// (B, M, D), (B, N, D) fp32 with 16-byte aligned rows, D a multiple of 32;
// scratch B * (2 nct M + 2 nrt N + M + N) floats (Scratch above).
int la_log_assignment(const void* a, const void* b, const void* za, const void* zb,
                      const void* mask_a, const void* mask_b, void* scores, void* rmax,
                      void* rarg, void* cmax, void* carg, void* scratch, int B, int M, int N,
                      int D, void* stream) {
  if (D % kKc || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(sim_kernel, kSimSmem);
  if (attr != cudaSuccess) return (int)attr;
  auto st = (cudaStream_t)stream;
  auto ma = (const unsigned char*)mask_a, mb = (const unsigned char*)mask_b;
  const Scratch sc = carve((float*)scratch, B, M, N);
  const dim3 tiles((N + kT - 1) / kT, (M + kT - 1) / kT, B);
  const dim3 lines((M + N + kThreads - 1) / kThreads, B);
  GF_LAUNCH(sim_kernel, tiles, kThreads, kSimSmem, st, (const float*)a, (const float*)b, ma, mb,
            (float*)scores, sc, M, N, D);
  GF_LAUNCH(lse_kernel, lines, kThreads, 0, st, (const float*)za, (const float*)zb, sc, M, N);
  GF_LAUNCH(finish_kernel, tiles, kThreads, 0, st, (const float*)za, (const float*)zb, ma, mb,
            (float*)scores, sc, M, N);
  GF_LAUNCH(argmax_kernel, lines, kThreads, 0, st, sc, (float*)rmax, (int*)rarg, (float*)cmax,
            (int*)carg, M, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
