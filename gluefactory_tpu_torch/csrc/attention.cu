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
//   fused_attention               (:253, call _fused_attention_bhnd :116,
//     body _attention_kernel :49)        -> attn_fwd_heads_kernel
//   fused_cross_attention         (:854, call _bidir_cross_bhnd :567,
//     body _bidir_cross_kernel :473)     -> cross_fwd_heads_kernel
//
// The last two are the per-head (B, H, N, 64) entries: the same forward tile
// with a head as a contiguous (N, 64) slab (row stride 64) in place of a
// channel slice of the packed row, so they run without the transposes that
// the two layouts differ by. The backward kernels take either layout as
// (set, head, row) strides.
//
// The TPU bodies keep a whole K/V set in VMEM and carry the column softmax
// of the cross attention, and dk/dv of the backward, along a sequential
// grid axis. CUDA blocks have no order, so here:
//   - every forward is the online-softmax tile of attention_fwd.cuh on the
//     packed (S, N, H*64) layout (heads are channel strides, no transposes);
//     it also writes the per-row log-sum-exp (S, H, N) for the backward;
//     the inputs' rows must be 16-byte aligned (the wrappers copy a
//     misaligned tensor);
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
//     dk = ds^T q (seven products for five: sim and dp are built in both).
//     It takes separate query and key sets and masks, because the cross
//     backward calls it once a direction. Two calls on the same inputs give
//     bit-identical gradients.
//
// Bound on the H100: at S = 64, N = 512, D = 256 the forward does 17 GFLOP
// on 134 MB of fp32 I/O and the backward 43 GFLOP on 235 MB: both are
// compute-bound (their inputs are fp32 in training). Both run their products
// on the tensor cores at fp32 accuracy: mma.sync m16n8k8 on TF32 operands,
// each fp32 operand split into hi = x rounded to TF32 and lo = x - hi
// (gf::split_tf32) and each product taken as lo.hi + hi.lo + hi.hi (three
// passes of the 495 TFLOP/s TF32 rate, about 2^-21 relative error a product
// against 2^-11 for one pass). A warp keeps its logits as C fragments and
// feeds p (and ds) to the next product as A fragments in a permuted
// contraction order, so they never leave registers. The forward is the
// FlashAttention-2 tile of attention_fwd.cuh (Q split once into registers,
// 64-key tiles double-buffered, key tiles without a valid key skipped). In
// the backward the block's own 64 rows stay in shared memory; the loop's
// tiles of 32 rows are double-buffered by cp.async, which keeps a block at
// 70 KB and 168 registers a thread: three blocks a multiprocessor. The
// backward's bf16 instantiation widens its tiles to fp32 and runs all three
// passes. The forwards' bf16 instantiations, the bf16 forms of
// _attention_kernel_packed (:319) and _bidir_cross_kernel_packed (:600), run
// the bf16 tile of attention_fwd.cuh: 128 queries a block, bf16 tiles by
// 16-byte cp.async in a two-stage ring (the fp32 tile's bf16 form widened
// them by synchronous loads, which overlapped nothing), one pass of bf16
// mma.sync m16n8k16 a product (it ran TF32 passes on the widened data), P
// rounded to bf16 as the Pallas kernels round it; wgmma waits (the tile's
// note says why). At S = 64, N = 512, D = 256 in bf16 the forward moves
// 34 MB, 0.0202 ms at 3.35 TB/s, against 17 GFLOP / 989 TFLOP/s = 0.017 ms:
// bound by bytes.
#include <type_traits>

#include "attention_fwd.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = gf::kAttnThreads;
constexpr int kTile = gf::kAttnTile;
constexpr int kDh = gf::kAttnDh;
constexpr int kPacked = 0;  // (S, N, H*64): a head is a channel slice of a row
constexpr int kHeads = 1;   // (S, H, N, 64): a head is a contiguous slab

// Element strides of one tensor: between sets, heads and rows.
struct Lay {
  size_t set, head;
  int row;
};

inline Lay make_lay(int layout, int N, int D, int H) {
  if (layout == kHeads) return Lay{(size_t)H * N * kDh, (size_t)N * kDh, kDh};
  return Lay{(size_t)N * D, (size_t)kDh, D};
}

// ------------------------------------------------------------- forward
// Each forward runs gf::attn_fwd_tile<T> on a block of gf::FwdTile<T>: 64
// queries and 4 warps in fp32, 128 queries and 8 warps in bf16. The fp32
// tile needs 166-176 registers a thread as compiled for each kernel; capped
// at 168 (three blocks of 4 warps an SM in place of two) the cross forwards
// run 10-14% faster at a training step's shape. K7a (SuperGlue's 512 blocks)
// ran 3% slower capped and is left uncapped in fp32
// (scripts/torch_fwd_k4_variants.py). The bf16 tile is capped at 128
// registers: two blocks of 8 warps an SM.
template <class T>
using Fwd = gf::FwdTile<T>;
template <class T>
constexpr int kK7aBlocks = std::is_same<T, float>::value ? 1 : Fwd<T>::kBlocks;

// K5. grid (ceil(Nq / Fwd<T>::kQueries), H, S): set s attends to itself.
template <class T>
__global__ void __launch_bounds__(Fwd<T>::kThreads, Fwd<T>::kBlocks) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mq, const unsigned char* __restrict__ mk,
    T* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, int D, float scale) {
  GF_DYN_SMEM(float, smem);
  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const size_t qb = (size_t)s * Nq * D + h * kDh, kb = (size_t)s * Nk * D + h * kDh;
  gf::attn_fwd_tile<T>(q + qb, k + kb, v + kb, mq ? mq + (size_t)s * Nq : nullptr,
                       mk ? mk + (size_t)s * Nk : nullptr, out + qb,
                       lse + ((size_t)s * H + h) * Nq, Nq, Nk, D,
                       blockIdx.x * Fwd<T>::kQueries, scale, smem);
}

// K6b. grid (ceil(N / Fwd<T>::kQueries), H, 2B): set s takes its keys and
// values from its partner (s + B) % 2B; out[s] holds the messages into set s.
template <class T>
__global__ void __launch_bounds__(Fwd<T>::kThreads, Fwd<T>::kBlocks) cross_fwd_stacked_kernel(
    const T* __restrict__ qk, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ lse, int B, int N, int D, float scale) {
  GF_DYN_SMEM(float, smem);
  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int o = (s + B) % (2 * B);
  const size_t qb = (size_t)s * N * D + h * kDh, kb = (size_t)o * N * D + h * kDh;
  gf::attn_fwd_tile<T>(qk + qb, qk + kb, v + kb, mask ? mask + (size_t)s * N : nullptr,
                       mask ? mask + (size_t)o * N : nullptr, out + qb,
                       lse + ((size_t)s * H + h) * N, N, N, D, blockIdx.x * Fwd<T>::kQueries,
                       scale, smem);
}

// K6a. grid (ceil(max(M, N) / Fwd<T>::kQueries), H, 2B): z < B is direction 0
// (queries of set 0, M rows, against set 1), z >= B direction 1.
template <class T>
__global__ void __launch_bounds__(Fwd<T>::kThreads, Fwd<T>::kBlocks) cross_fwd_pair_kernel(
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
  const int i0 = blockIdx.x * Fwd<T>::kQueries;
  if (i0 >= nq) return;
  const size_t qb = (size_t)b * nq * D + h * kDh, kb = (size_t)b * nk * D + h * kDh;
  const unsigned char* mq = fwd ? mask0 : mask1;
  const unsigned char* mk = fwd ? mask1 : mask0;
  gf::attn_fwd_tile<T>((fwd ? qk0 : qk1) + qb, (fwd ? qk1 : qk0) + kb, (fwd ? v1 : v0) + kb,
                       mq ? mq + (size_t)b * nq : nullptr, mk ? mk + (size_t)b * nk : nullptr,
                       (fwd ? out0 : out1) + qb, (fwd ? lse0 : lse1) + ((size_t)b * H + h) * nq,
                       nq, nk, D, i0, scale, smem);
}

// K7a. grid (ceil(Nq / Fwd<T>::kQueries), H, B) on the per-head layout: q,
// out (B, H, Nq, 64), k, v (B, H, Nk, 64), separate query and key masks.
template <class T>
__global__ void __launch_bounds__(Fwd<T>::kThreads, kK7aBlocks<T>) attn_fwd_heads_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mq, const unsigned char* __restrict__ mk,
    T* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, float scale) {
  GF_DYN_SMEM(float, smem);
  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const size_t slab = (size_t)s * H + h;
  gf::attn_fwd_tile<T>(q + slab * Nq * kDh, k + slab * Nk * kDh, v + slab * Nk * kDh,
                       mq ? mq + (size_t)s * Nq : nullptr, mk ? mk + (size_t)s * Nk : nullptr,
                       out + slab * Nq * kDh, lse + slab * Nq, Nq, Nk, kDh,
                       blockIdx.x * Fwd<T>::kQueries, scale, smem);
}

// K7c. grid (ceil(max(M, N) / Fwd<T>::kQueries), H, 2B) on the per-head
// layout: z < B is direction 0 (queries of set 0, M rows, against set 1),
// z >= B direction 1.
template <class T>
__global__ void __launch_bounds__(Fwd<T>::kThreads, Fwd<T>::kBlocks) cross_fwd_heads_kernel(
    const T* __restrict__ qk0, const T* __restrict__ qk1, const T* __restrict__ v0,
    const T* __restrict__ v1, const unsigned char* __restrict__ mask0,
    const unsigned char* __restrict__ mask1, T* __restrict__ out0, T* __restrict__ out1,
    float* __restrict__ lse0, float* __restrict__ lse1, int B, int M, int N, float scale) {
  GF_DYN_SMEM(float, smem);
  const int h = blockIdx.y, H = gridDim.y;
  const bool fwd = (int)blockIdx.z < B;
  const int b = fwd ? blockIdx.z : blockIdx.z - B;
  const int nq = fwd ? M : N, nk = fwd ? N : M;
  const int i0 = blockIdx.x * Fwd<T>::kQueries;
  if (i0 >= nq) return;
  const size_t slab = (size_t)b * H + h;
  const unsigned char* mq = fwd ? mask0 : mask1;
  const unsigned char* mk = fwd ? mask1 : mask0;
  gf::attn_fwd_tile<T>((fwd ? qk0 : qk1) + slab * nq * kDh, (fwd ? qk1 : qk0) + slab * nk * kDh,
                       (fwd ? v1 : v0) + slab * nk * kDh, mq ? mq + (size_t)b * nq : nullptr,
                       mk ? mk + (size_t)b * nk : nullptr,
                       (fwd ? out0 : out1) + slab * nq * kDh, (fwd ? lse0 : lse1) + slab * nq,
                       nq, nk, kDh, i0, scale, smem);
}

// ------------------------------------------------------------ backward
// K7b on the tensor cores: 64-row tiles, 4 warps a block, a warp owns 16 rows
// of its block's tile. The staged tiles are fp32 in shared memory at row
// stride kBPad = 68 floats (272 bytes: 16-byte aligned rows), so every
// fragment load below (ldmatrix row-wise; scalar down the columns: rows 2t,
// columns g) is free of bank conflicts.
constexpr int kBPad = gf::kAttnPad;
constexpr int kBTileF = kTile * kBPad;  // floats of the block's own 64-row tile
constexpr int kStep = 32;  // rows of the loop's tiles (queries for dk/dv, keys for dq)
constexpr float kLog2e = 1.4426950408889634f;  // p = 2^(sim scale log2(e) - lse log2(e))
constexpr int kStepF = kStep * kBPad;
// dk/dv: K, V, two Q and two dO buffers, lse / delta / validity of two query tiles
constexpr int kDkvSmem = (2 * kBTileF + 4 * kStepF + 6 * kStep) * sizeof(float);
// dq: Q, dO, two K and two V buffers, validity of two key tiles
constexpr int kDqSmem = (2 * kBTileF + 4 * kStepF + 2 * kStep) * sizeof(float);

// delta[s, h, i] = sum_d do[s, h, i, d] * o[s, h, i, d]: a warp a row, two
// channels a lane, reduced by shuffles
template <class T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    int S, int Nq, Lay lq, int H) {
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= (size_t)S * H * Nq) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int i = row % Nq, h = (row / Nq) % H, s = row / ((size_t)Nq * H);
  const size_t at = s * lq.set + h * lq.head + (size_t)i * lq.row + 2 * lane;
  float acc = gf::to_f(o[at]) * gf::to_f(dout[at]);
  acc = fmaf(gf::to_f(o[at + 1]), gf::to_f(dout[at + 1]), acc);
  for (int m = 16; m > 0; m >>= 1) acc += gf::shfl_xor(acc, m);
  if (lane == 0) delta[row] = acc;
}

// grid (ceil(Nk / 64), H, S). The block owns key tile j0 and its dk, dv; it
// loops over tiles of kStep queries, the next one's Q and dO in flight while
// this one's run. A warp holds sim^T and dp^T of its 16 keys against the
// tile's queries as C fragments, turns them into p^T and ds^T in place and
// feeds them as the A operand of dv += p^T do and dk += ds^T q.
template <class T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mq,
    const unsigned char* __restrict__ mk, T* __restrict__ dk, T* __restrict__ dv,
    int Nq, int Nk, Lay lq, Lay lk, float scale) {
  GF_DYN_SMEM(float, smem);
  float* Ks = smem;                  // [j][d]
  float* Vs = Ks + kBTileF;          // [j][d]
  float* Qs = Vs + kBTileF;          // [2][i][d]
  float* dOs = Qs + 2 * kStepF;      // [2][i][d]
  float* rows = dOs + 2 * kStepF;    // [2][lse log2(e), delta, validity][i]

  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y, j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, m0 = tid / 32 * 16, g = tid % 32 / 4, t = tid % 4;
  const size_t qb = s * lq.set + h * lq.head, kb = s * lk.set + h * lk.head;
  const size_t rb = ((size_t)s * H + h) * Nq;

  auto stage_queries = [&](int it) {
    const int buf = it & 1, i0 = it * kStep;
    gf::stage_rows<kStep, T>(Qs + buf * kStepF, q + qb, i0, Nq, lq.row);
    gf::stage_rows<kStep, T>(dOs + buf * kStepF, dout + qb, i0, Nq, lq.row);
    if (tid < kStep) {
      const int gi = i0 + tid;
      const bool in = gi < Nq;
      float* r = rows + buf * 3 * kStep;
      r[tid] = in ? lse[rb + gi] * kLog2e : 0.f;
      r[kStep + tid] = in ? delta[rb + gi] : 0.f;
      r[2 * kStep + tid] = (in && (mq == nullptr || mq[(size_t)s * Nq + gi])) ? 1.f : 0.f;
    }
    gf::cp_async_commit();
  };
  gf::stage_rows<kTile, T>(Ks, k + kb, j0, Nk, lk.row);
  gf::stage_rows<kTile, T>(Vs, v + kb, j0, Nk, lk.row);
  stage_queries(0);
  bool kv[2];
  for (int r = 0; r < 2; ++r) {
    const int gj = j0 + m0 + g + 8 * r;
    kv[r] = gj < Nk && (mk == nullptr || mk[(size_t)s * Nk + gj]);
  }

  float dka[8][4] = {}, dva[8][4] = {};
  const float scale2 = scale * kLog2e;
  const int tiles = (Nq + kStep - 1) / kStep;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      stage_queries(it + 1);  // its buffers were last read before the previous barrier
      gf::cp_async_wait<1>();
    } else {
      gf::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (it & 1) * kStepF;
    const float* dOt = dOs + (it & 1) * kStepF;
    const float* rw = rows + (it & 1) * 3 * kStep;

    // sim^T, dp^T: (key m0 + g (+8), query 8 nt + 2t (+1))
    float st[kStep / 8][4] = {}, dpt[kStep / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      unsigned kh[4], kl[4], vh[4], vl[4];
      gf::frag_a<kBPad>(kh, kl, Ks, m0, 8 * ks);
      gf::frag_a<kBPad>(vh, vl, Vs, m0, 8 * ks);
#pragma unroll
      for (int nt = 0; nt < kStep / 8; nt += 2) {
        unsigned bh[4], bl[4];
        gf::frag_b_rows<kBPad>(bh, bl, Qt, 8 * nt, 8 * ks);
        gf::mma_tf32x3(st[nt], kh, kl, bh, bl);
        gf::mma_tf32x3(st[nt + 1], kh, kl, bh + 2, bl + 2);
        gf::frag_b_rows<kBPad>(bh, bl, dOt, 8 * nt, 8 * ks);
        gf::mma_tf32x3(dpt[nt], vh, vl, bh, bl);
        gf::mma_tf32x3(dpt[nt + 1], vh, vl, bh + 2, bl + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + 2 * t + (e & 1);
        const bool ok = kv[e >> 1] && rw[2 * kStep + i] > 0.f;
        const float p = ok ? exp2f(fmaf(st[nt][e], scale2, -rw[i])) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - rw[kStep + i]) * scale;  // ds
      }
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk) {
      unsigned ph[4], pl[4], sh[4], sl[4];
      gf::frag_c(ph, pl, st[kk]);
      gf::frag_c(sh, sl, dpt[kk]);
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        unsigned bh[2], bl[2];
        gf::frag_b_cols<kBPad>(bh, bl, dOt, 8 * kk, 8 * nd);
        gf::mma_tf32x3(dva[nd], ph, pl, bh, bl);  // dv[j][d] += sum_i p[i][j] do[i][d]
        gf::frag_b_cols<kBPad>(bh, bl, Qt, 8 * kk, 8 * nd);
        gf::mma_tf32x3(dka[nd], sh, sl, bh, bl);  // dk[j][d] += sum_i ds[i][j] q[i][d]
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gj = j0 + m0 + g + 8 * r;
    if (gj >= Nk) continue;
    const size_t at = kb + (size_t)gj * lk.row + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      gf::store2(dk + at + 8 * nd, dka[nd][2 * r], dka[nd][2 * r + 1]);
      gf::store2(dv + at + 8 * nd, dva[nd][2 * r], dva[nd][2 * r + 1]);
    }
  }
}

// grid (ceil(Nq / 64), H, S). The block owns query tile i0 and its dq; it
// loops over tiles of kStep keys, the next one's K and V in flight. A warp
// holds sim and dp of its 16 queries against the tile's keys, turns them into
// ds in place and feeds it as the A operand of dq += ds k.
template <class T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mq,
    const unsigned char* __restrict__ mk, T* __restrict__ dq,
    int Nq, int Nk, Lay lq, Lay lk, float scale) {
  GF_DYN_SMEM(float, smem);
  float* Qs = smem;                 // [i][d]
  float* dOs = Qs + kBTileF;        // [i][d]
  float* Ks = dOs + kBTileF;        // [2][j][d]
  float* Vs = Ks + 2 * kStepF;      // [2][j][d]
  float* kval = Vs + 2 * kStepF;    // [2][j]

  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y, i0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, m0 = tid / 32 * 16, g = tid % 32 / 4, t = tid % 4;
  const size_t qb = s * lq.set + h * lq.head, kb = s * lk.set + h * lk.head;
  const size_t rb = ((size_t)s * H + h) * Nq;

  auto stage_keys = [&](int it) {
    const int buf = it & 1, j0 = it * kStep;
    gf::stage_rows<kStep, T>(Ks + buf * kStepF, k + kb, j0, Nk, lk.row);
    gf::stage_rows<kStep, T>(Vs + buf * kStepF, v + kb, j0, Nk, lk.row);
    if (tid < kStep) {
      const int gj = j0 + tid;
      kval[buf * kStep + tid] =
          (gj < Nk && (mk == nullptr || mk[(size_t)s * Nk + gj])) ? 1.f : 0.f;
    }
    gf::cp_async_commit();
  };
  gf::stage_rows<kTile, T>(Qs, q + qb, i0, Nq, lq.row);
  gf::stage_rows<kTile, T>(dOs, dout + qb, i0, Nq, lq.row);
  stage_keys(0);
  bool qv[2];
  float rl[2], rd[2];
  for (int r = 0; r < 2; ++r) {
    const int gi = i0 + m0 + g + 8 * r;
    const bool in = gi < Nq;
    qv[r] = in && (mq == nullptr || mq[(size_t)s * Nq + gi]);
    rl[r] = in ? lse[rb + gi] * kLog2e : 0.f;
    rd[r] = in ? delta[rb + gi] : 0.f;
  }

  float dqa[8][4] = {};
  const float scale2 = scale * kLog2e;
  const int tiles = (Nk + kStep - 1) / kStep;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      stage_keys(it + 1);
      gf::cp_async_wait<1>();
    } else {
      gf::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (it & 1) * kStepF;
    const float* Vt = Vs + (it & 1) * kStepF;
    const float* kvt = kval + (it & 1) * kStep;

    // sim, dp: (query m0 + g (+8), key 8 nt + 2t (+1))
    float sa[kStep / 8][4] = {}, dpa[kStep / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      unsigned qh[4], ql[4], oh[4], ol[4];
      gf::frag_a<kBPad>(qh, ql, Qs, m0, 8 * ks);
      gf::frag_a<kBPad>(oh, ol, dOs, m0, 8 * ks);
#pragma unroll
      for (int nt = 0; nt < kStep / 8; nt += 2) {
        unsigned bh[4], bl[4];
        gf::frag_b_rows<kBPad>(bh, bl, Kt, 8 * nt, 8 * ks);
        gf::mma_tf32x3(sa[nt], qh, ql, bh, bl);
        gf::mma_tf32x3(sa[nt + 1], qh, ql, bh + 2, bl + 2);
        gf::frag_b_rows<kBPad>(bh, bl, Vt, 8 * nt, 8 * ks);
        gf::mma_tf32x3(dpa[nt], oh, ol, bh, bl);
        gf::mma_tf32x3(dpa[nt + 1], oh, ol, bh + 2, bl + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * nt + 2 * t + (e & 1), r = e >> 1;
        const bool ok = qv[r] && kvt[j] > 0.f;
        const float p = ok ? exp2f(fmaf(sa[nt][e], scale2, -rl[r])) : 0.f;
        sa[nt][e] = p * (dpa[nt][e] - rd[r]) * scale;  // ds
      }
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk) {
      unsigned sh[4], sl[4];
      gf::frag_c(sh, sl, sa[kk]);
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        unsigned bh[2], bl[2];
        gf::frag_b_cols<kBPad>(bh, bl, Kt, 8 * kk, 8 * nd);
        gf::mma_tf32x3(dqa[nd], sh, sl, bh, bl);  // dq[i][d] += sum_j ds[i][j] k[j][d]
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = i0 + m0 + g + 8 * r;
    if (gi >= Nq) continue;
    const size_t at = qb + (size_t)gi * lq.row + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) gf::store2(dq + at + 8 * nd, dqa[nd][2 * r], dqa[nd][2 * r + 1]);
  }
}

// ------------------------------------------------------------ launchers
template <class T>
int launch_attn_fwd(const void* q, const void* k, const void* v, const unsigned char* mq,
                    const unsigned char* mk, void* out, float* lse, int S, int Nq, int Nk,
                    int D, int H, float scale, cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(attn_fwd_kernel<T>, Fwd<T>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Nq + Fwd<T>::kQueries - 1) / Fwd<T>::kQueries, H, S);
  GF_LAUNCH(attn_fwd_kernel<T>, grid, Fwd<T>::kThreads, Fwd<T>::kSmem, st, (const T*)q,
            (const T*)k, (const T*)v, mq, mk, (T*)out, lse, Nq, Nk, D, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_cross_stacked(const void* qk, const void* v, const unsigned char* mask, void* out,
                         float* lse, int B, int N, int D, int H, float scale,
                         cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(cross_fwd_stacked_kernel<T>, Fwd<T>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + Fwd<T>::kQueries - 1) / Fwd<T>::kQueries, H, 2 * B);
  GF_LAUNCH(cross_fwd_stacked_kernel<T>, grid, Fwd<T>::kThreads, Fwd<T>::kSmem, st,
            (const T*)qk, (const T*)v, mask, (T*)out, lse, B, N, D, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_cross_pair(const void* qk0, const void* qk1, const void* v0, const void* v1,
                      const unsigned char* mask0, const unsigned char* mask1, void* out0,
                      void* out1, float* lse0, float* lse1, int B, int M, int N, int D,
                      int H, float scale, cudaStream_t st) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = gf::allow_smem(cross_fwd_pair_kernel<T>, Fwd<T>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int longer = M > N ? M : N;
  dim3 grid((longer + Fwd<T>::kQueries - 1) / Fwd<T>::kQueries, H, 2 * B);
  GF_LAUNCH(cross_fwd_pair_kernel<T>, grid, Fwd<T>::kThreads, Fwd<T>::kSmem, st, (const T*)qk0,
            (const T*)qk1, (const T*)v0, (const T*)v1, mask0, mask1, (T*)out0, (T*)out1,
            lse0, lse1, B, M, N, D, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_attn_heads(const void* q, const void* k, const void* v, const unsigned char* mq,
                      const unsigned char* mk, void* out, float* lse, int B, int H, int Nq,
                      int Nk, float scale, cudaStream_t st) {
  static cudaError_t attr = gf::allow_smem(attn_fwd_heads_kernel<T>, Fwd<T>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Nq + Fwd<T>::kQueries - 1) / Fwd<T>::kQueries, H, B);
  GF_LAUNCH(attn_fwd_heads_kernel<T>, grid, Fwd<T>::kThreads, Fwd<T>::kSmem, st, (const T*)q,
            (const T*)k, (const T*)v, mq, mk, (T*)out, lse, Nq, Nk, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_cross_heads(const void* qk0, const void* qk1, const void* v0, const void* v1,
                       const unsigned char* mask0, const unsigned char* mask1, void* out0,
                       void* out1, float* lse0, float* lse1, int B, int H, int M, int N,
                       float scale, cudaStream_t st) {
  static cudaError_t attr = gf::allow_smem(cross_fwd_heads_kernel<T>, Fwd<T>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int longer = M > N ? M : N;
  dim3 grid((longer + Fwd<T>::kQueries - 1) / Fwd<T>::kQueries, H, 2 * B);
  GF_LAUNCH(cross_fwd_heads_kernel<T>, grid, Fwd<T>::kThreads, Fwd<T>::kSmem, st, (const T*)qk0,
            (const T*)qk1, (const T*)v0, (const T*)v1, mask0, mask1, (T*)out0, (T*)out1,
            lse0, lse1, B, M, N, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, const unsigned char* mq,
                    const unsigned char* mk, float* delta, void* dq, void* dk, void* dv,
                    int S, int Nq, int Nk, int D, int H, float scale, int layout,
                    cudaStream_t st) {
  if (D != H * kDh || (layout != kPacked && layout != kHeads)) return (int)cudaErrorInvalidValue;
  const Lay lq = make_lay(layout, Nq, D, H), lk = make_lay(layout, Nk, D, H);
  static cudaError_t attr_kv = gf::allow_smem(attn_bwd_dkv_kernel<T>, kDkvSmem);
  static cudaError_t attr_q = gf::allow_smem(attn_bwd_dq_kernel<T>, kDqSmem);
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  if (attr_q != cudaSuccess) return (int)attr_q;
  const size_t rows = (size_t)S * H * Nq, warps = kThreads / 32;
  GF_LAUNCH(attn_bwd_delta_kernel<T>, dim3((unsigned)((rows + warps - 1) / warps)), kThreads, 0,
            st, (const T*)o, (const T*)dout, delta, S, Nq, lq, H);
  GF_LAUNCH(attn_bwd_dkv_kernel<T>, dim3((Nk + kTile - 1) / kTile, H, S), kThreads, kDkvSmem,
            st, (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
            (const float*)delta, mq, mk, (T*)dk, (T*)dv, Nq, Nk, lq, lk, scale);
  GF_LAUNCH(attn_bwd_dq_kernel<T>, dim3((Nq + kTile - 1) / kTile, H, S), kThreads, kDqSmem,
            st, (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
            (const float*)delta, mq, mk, (T*)dq, Nq, Nk, lq, lk, scale);
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
                int dtype, int layout, void* stream) {
  auto st = (cudaStream_t)stream;
  auto a = (const unsigned char*)mq, b = (const unsigned char*)mk;
  if (dtype == gf::kBF16)
    return launch_attn_bwd<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, a, b,
                                          (float*)delta, dq, dk, dv, S, Nq, Nk, D, H, scale,
                                          layout, st);
  return launch_attn_bwd<float>(q, k, v, o, dout, (const float*)lse, a, b, (float*)delta, dq,
                                dk, dv, S, Nq, Nk, D, H, scale, layout, st);
}

// The per-head entries: (B, H, N, 64) tensors, fp32 or bf16.
int at_attn_fwd_heads(const void* q, const void* k, const void* v, const void* mq,
                      const void* mk, void* out, void* lse, int B, int H, int Nq, int Nk,
                      float scale, int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto a = (const unsigned char*)mq, b = (const unsigned char*)mk;
  if (dtype == gf::kBF16)
    return launch_attn_heads<__nv_bfloat16>(q, k, v, a, b, out, (float*)lse, B, H, Nq, Nk,
                                            scale, st);
  return launch_attn_heads<float>(q, k, v, a, b, out, (float*)lse, B, H, Nq, Nk, scale, st);
}

int at_cross_fwd_heads(const void* qk0, const void* qk1, const void* v0, const void* v1,
                       const void* mask0, const void* mask1, void* out0, void* out1,
                       void* lse0, void* lse1, int B, int H, int M, int N, float scale,
                       int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto a = (const unsigned char*)mask0, b = (const unsigned char*)mask1;
  if (dtype == gf::kBF16)
    return launch_cross_heads<__nv_bfloat16>(qk0, qk1, v0, v1, a, b, out0, out1, (float*)lse0,
                                             (float*)lse1, B, H, M, N, scale, st);
  return launch_cross_heads<float>(qk0, qk1, v0, v1, a, b, out0, out1, (float*)lse0,
                                   (float*)lse1, B, H, M, N, scale, st);
}

}  // extern "C"
