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
//     -> attn_bwd_delta_kernel, attn_bwd_dkv_kernel, attn_bwd_dq_kernel (fp32),
//        attn_bwd_delta_bf16_kernel, attn_bwd_dkv_bf16_kernel,
//        attn_bwd_dq_bf16_kernel (bf16)
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
//     At Dh = 64 that costs less than one kernel writing per-key-tile dq
//     partials: with 128-key tiles at N = 512 those are four fp32 copies of
//     dq, 134 MB written and read at (64, 512, 256), as much as all of the
//     bf16 backward's I/O. It takes separate query and key sets and masks,
//     because the cross backward calls it once a direction. Two calls on
//     the same inputs give bit-identical gradients.
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
// the fp32 backward the block's own 64 rows stay in shared memory; the
// loop's tiles of 32 rows are double-buffered by cp.async, which keeps a
// block at 70 KB and 168 registers a thread: three blocks a multiprocessor.
// The forwards' bf16 instantiations, the bf16 forms of
// _attention_kernel_packed (:319) and _bidir_cross_kernel_packed (:600), run
// the bf16 tile of attention_fwd.cuh: 128 queries a block, bf16 tiles by
// 16-byte cp.async in a two-stage ring (the fp32 tile's bf16 form widened
// them by synchronous loads, which overlapped nothing), one pass of bf16
// mma.sync m16n8k16 a product (it ran TF32 passes on the widened data), P
// rounded to bf16 as the Pallas kernels round it; wgmma waits (the tile's
// note says why). At S = 64, N = 512, D = 256 in bf16 the forward moves
// 34 MB, 0.0202 ms at 3.35 TB/s, against 17 GFLOP / 989 TFLOP/s = 0.017 ms:
// bound by bytes.
//
// The bf16 backward (the bf16 form of _attention_bwd_kernel,
// pallas_attention.py:143, K7b of a `mp: True` training step) has kernels
// of its own, its delta pass reading 16 bytes a lane. It was the fp32 design
// run on widened data: every tile staged by one synchronous 2-byte load an
// element into fp32 shared memory (70 KB a block; its double buffer
// overlapped nothing) and every product three split-TF32 passes on operands
// that are exact in one. Here Q, K, V and dO are bf16 in shared memory at row
// stride 72 (17 KB of loop tiles, 37 KB a block), filled by 16-byte
// cp.async (rows past the set zero-filled) into a two-stage ring, the next
// tile's copy in flight while this tile's products run; the block's own
// rows are read once into registers as A fragments (K and V in dk/dv, Q and
// dO in dq). Every product is one pass of bf16 mma.sync m16n8k16 (twice the
// TF32 rate, twice its contraction depth an instruction): s^T = K Q^T and
// dp^T = V dO^T, dv += p^T dO and dk += ds^T Q (dO and Q by ldmatrix.trans);
// s = Q K^T, dp = dO V^T and dq += ds K. p = 2^(s scale log2(e) - lse
// log2(e)) by ex2.approx in fp32 (masked pairs and rows past the set exactly
// 0), ds = p (dp - delta) scale from the fp32 p, and both are rounded to
// bf16 as the next product's A operand straight from their C fragments, as
// the Pallas kernel rounds p.astype(cdt) and ds.astype(cdt) (:177-198). Two
// differences from it, chosen: dk, dv and dq accumulate in fp32 over the
// whole loop and are rounded to bf16 once, at the store (the Pallas kernel
// adds dk and dv into its bf16 output once a 256-query grid step, :195-198),
// and delta is rowsum(do * o) of the forward's bf16 output (its delta is
// rowsum(p dp) in fp32, :189). At S = 64, N = 512, D = 256 the bf16
// backward moves 134 MB (q, k, v, o, do read, dq, dk, dv written), 0.040 ms
// at 3.35 TB/s, against five products on the ~64% valid pairs, 27 GFLOP,
// 0.028 ms at 989 TFLOP/s: bound by bytes. wgmma waits: tests/cuda_emu
// cannot model its shared-memory descriptors, so a wgmma kernel could not
// be run before the card.
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
// K7b in fp32 on the tensor cores: 64-row tiles, 4 warps a block, a warp owns
// 16 rows of its block's tile. The staged tiles are fp32 in shared memory at row
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
  static_assert(std::is_same<T, float>::value, "bf16 has its own kernels below");
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
    gf::stage_rows<kStep>(Qs + buf * kStepF, q + qb, i0, Nq, lq.row);
    gf::stage_rows<kStep>(dOs + buf * kStepF, dout + qb, i0, Nq, lq.row);
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
  gf::stage_rows<kTile>(Ks, k + kb, j0, Nk, lk.row);
  gf::stage_rows<kTile>(Vs, v + kb, j0, Nk, lk.row);
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
  static_assert(std::is_same<T, float>::value, "bf16 has its own kernels below");
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
    gf::stage_rows<kStep>(Ks + buf * kStepF, k + kb, j0, Nk, lk.row);
    gf::stage_rows<kStep>(Vs + buf * kStepF, v + kb, j0, Nk, lk.row);
    if (tid < kStep) {
      const int gj = j0 + tid;
      kval[buf * kStep + tid] =
          (gj < Nk && (mk == nullptr || mk[(size_t)s * Nk + gj])) ? 1.f : 0.f;
    }
    gf::cp_async_commit();
  };
  gf::stage_rows<kTile>(Qs, q + qb, i0, Nq, lq.row);
  gf::stage_rows<kTile>(dOs, dout + qb, i0, Nq, lq.row);
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

// ------------------------------------------------------ backward, bf16
// K7b in bf16 (see the note at the top): the fp32 kernels' structure on bf16
// tiles. The block's own kRows rows (keys in dk/dv, queries in dq), a warp
// for every 16, are read once into registers as A fragments; the loop's
// tiles of kLoop rows are bf16 in shared memory at row stride kStride (144
// bytes: the eight rows of an ldmatrix on distinct banks), filled by 16-byte
// cp.async into a two-stage ring, the next tile's copy in flight while this
// tile's products run. Every product is one pass of mma.sync m16n8k16 (bf16
// in, fp32 accumulators); p and ds are rounded to bf16 as the A operand of
// the next product, straight from the C fragments.
using bf16 = __nv_bfloat16;
constexpr int kStride = Fwd<bf16>::kStride;  // row stride of the bf16 tiles, as the forward's

// A bf16 backward kernel's block: `rows` rows of its own, `loop` rows a
// loop tile, `blocks` blocks a multiprocessor asked of ptxas (a register cap)
template <int rows, int loop, int blocks>
struct BwdShape {
  static constexpr int kRows = rows, kLoop = loop, kBlocks = blocks;
  static constexpr int kThreads = 2 * rows;  // a warp for every 16 rows
  // the block's two tiles and two stages of the loop's two tiles, in bf16
  static constexpr int kTiles = (2 * kRows + 4 * kLoop) * kStride * 2;
};
using Dkv = BwdShape<128, 32, 2>;  // dk/dv: 128 keys, 32-query tiles
using Dq = BwdShape<128, 32, 2>;   // dq: 128 queries, 32-key tiles
// and lse log2(e) and delta of the queries of two stages
constexpr int kDkvBf16Smem = Dkv::kTiles + 2 * 2 * Dkv::kLoop * (int)sizeof(float);
// and the validity bytes of the keys of two stages
constexpr int kDqBf16Smem = Dq::kTiles + 2 * Dq::kLoop;

// delta[s, h, i] = sum_d do[s, h, i, d] * o[s, h, i, d] in bf16: eight lanes
// a row, 16 bytes (eight channels) a lane, summed over the eight by three
// shuffles; four rows a warp
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_bf16_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
    int S, int Nq, Lay lq, int H) {
  const size_t row = ((size_t)blockIdx.x * kThreads + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  const bool in = row < (size_t)S * H * Nq;  // every lane goes on to the shuffles
  float acc = 0.f;
  if (in) {
    const int i = row % Nq, h = (row / Nq) % H, s = row / ((size_t)Nq * H);
    const size_t at = s * lq.set + h * lq.head + (size_t)i * lq.row + 8 * part;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const unsigned wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      acc = fmaf(gf::bf16_lo(wa[w]), gf::bf16_lo(wb[w]), acc);
      acc = fmaf(gf::bf16_hi(wa[w]), gf::bf16_hi(wb[w]), acc);
    }
  }
  for (int m = 4; m > 0; m >>= 1) acc += gf::shfl_xor(acc, m);
  if (in && part == 0) delta[row] = acc;
}

// Rows [r0, r0 + rows) of one head (row stride ld) into dst at row stride
// kStride, eight 16-byte cp.async a row by the block's `threads` (the caller
// commits and waits); rows from n on are zero-filled.
template <int rows, int threads>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* __restrict__ src, int r0,
                                           int n, int ld) {
  for (int e = threadIdx.x; e < rows * 8; e += threads) {
    const int r = e / 8, c = e % 8 * 8;
    const bool in = r0 + r < n;
    gf::cp_async16(dst + r * kStride + c, src + (size_t)(in ? r0 + r : 0) * ld + c, in);
  }
}

// This warp's 16 rows of a [row][d] tile as the A fragments of four k16 steps
__device__ __forceinline__ void frags_a(unsigned f[4][4], const bf16* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    gf::ldsm_x4(f[kk], tile + (warp * 16 + lane % 16) * kStride + kk * 16 + lane / 16 * 8);
}

// c[n] += sum_d a[m][d] tile[n][d] over the `loop` rows n of a loop tile:
// c holds (m g (+8), n 8nt + 2t (+1)); B by ldmatrix down the tile's rows
template <int loop>
__device__ __forceinline__ void product_rows(float c[][4], const unsigned a[4][4],
                                             const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nj = 0; nj < loop / 16; ++nj) {
      unsigned b[4];  // rows 16nj.. as two n8 tiles, d 16kk..
      gf::ldsm_x4(b, tile + (nj * 16 + lane / 16 * 8 + lane % 8) * kStride + kk * 16 +
                         lane / 8 % 2 * 8);
      gf::mma_bf16_m16n8k16(c[2 * nj], a[kk], b);
      gf::mma_bf16_m16n8k16(c[2 * nj + 1], a[kk], b + 2);
    }
}

// acc[m][d] += sum_n c[m][n] tile[n][d] over the loop tile's rows n, c
// rounded to bf16 (the C fragments of two n8 tiles make one k16 A fragment);
// B by ldmatrix.trans
template <int loop>
__device__ __forceinline__ void product_cols(float acc[8][4], const float c[][4],
                                             const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < loop / 16; ++kk) {
    const unsigned a[4] = {gf::pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           gf::pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           gf::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           gf::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) {
      unsigned b[4];  // rows 16kk.., d 16dj.. as two n8 tiles
      gf::ldsm_x4_trans(b, tile + (kk * 16 + lane / 8 % 2 * 8 + lane % 8) * kStride + dj * 16 +
                               lane / 16 * 8);
      gf::mma_bf16_m16n8k16(acc[2 * dj], a, b);
      gf::mma_bf16_m16n8k16(acc[2 * dj + 1], a, b + 2);
    }
  }
}

// This warp's rows row0 + g (+8) of acc (d 8nd + 2t (+1)), rounded to bf16
// once, into out at row stride ld; rows from n on are left out
__device__ __forceinline__ void store_rows(bf16* out, const float acc[8][4], int row0, int n,
                                           int ld) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      gf::store2(out + (size_t)row * ld + 8 * nd + 2 * t, acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

// grid (ceil(Nk / kRows), H, S). The block owns keys [j0, j0 + kRows) and
// their dk, dv; a warp owns 16 of them. Per query tile: s^T = K Q^T and
// dp^T = V dO^T as C fragments, p^T and ds^T in place, then dv += p^T dO
// and dk += ds^T Q. K's and V's fragments are read again each tile: kept
// in registers they take the kernel past the 128 registers of two 8-warp
// blocks a multiprocessor.
__global__ void __launch_bounds__(Dkv::kThreads, Dkv::kBlocks) attn_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mq,
    const unsigned char* __restrict__ mk, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int Nq, int Nk, Lay lq, Lay lk, float scale) {
  constexpr int kR = Dkv::kRows, kL = Dkv::kLoop, kT = Dkv::kThreads, kS = kStride;
  GF_DYN_SMEM(bf16, smem);
  bf16* Ks = smem;                 // [kR][kS]
  bf16* Vs = Ks + kR * kS;         // [kR][kS]
  bf16* Qs = Vs + kR * kS;         // [2][kL][kS]
  bf16* dOs = Qs + 2 * kL * kS;    // [2][kL][kS]
  float* rows = reinterpret_cast<float*>(dOs + 2 * kL * kS);  // [2][lse log2(e), delta][kL]

  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y, j0 = blockIdx.x * kR;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const size_t qb = s * lq.set + h * lq.head, kb = s * lk.set + h * lk.head;
  const size_t rb = ((size_t)s * H + h) * Nq;

  // thread tid < kL: query row i's lse log2(e) (+inf for a row that is
  // invalid or past the set: its p is then exactly 0) and delta
  float rl = 0.f, rd = 0.f;
  auto row_values = [&](int i) {
    const bool ok = i < Nq && (mq == nullptr || mq[(size_t)s * Nq + i]);
    rl = ok ? lse[rb + i] * kLog2e : INFINITY;
    rd = ok ? delta[rb + i] : 0.f;
  };
  auto stage_queries = [&](int it) {  // into stage it % 2 of the ring
    const int buf = it & 1;
    stage_bf16<kL, kT>(Qs + buf * kL * kS, q + qb, it * kL, Nq, lq.row);
    stage_bf16<kL, kT>(dOs + buf * kL * kS, dout + qb, it * kL, Nq, lq.row);
  };
  stage_bf16<kR, kT>(Ks, k + kb, j0, Nk, lk.row);
  stage_bf16<kR, kT>(Vs, v + kb, j0, Nk, lk.row);
  stage_queries(0);
  gf::cp_async_commit();
  if (tid < kL) {
    row_values(tid);
    rows[tid] = rl;
    rows[kL + tid] = rd;
  }
  bool kv[2];  // keys j0 + 16 warp + g (+8)
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + warp * 16 + g + 8 * r;
    kv[r] = j < Nk && (mk == nullptr || mk[(size_t)s * Nk + j]);
  }

  float dka[8][4] = {}, dva[8][4] = {};  // (key g (+8), d 8nd + 2t (+1))
  const float scale2 = scale * kLog2e;
  const int tiles = (Nq + kL - 1) / kL;
  for (int it = 0; it < tiles; ++it) {
    gf::cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < tiles) {
      stage_queries(it + 1);  // into tile it - 1's stage
      if (tid < kL) row_values((it + 1) * kL + tid);  // stored after this tile's products
    }
    gf::cp_async_commit();
    const bf16* Qt = Qs + (it & 1) * kL * kS;
    const bf16* dOt = dOs + (it & 1) * kL * kS;
    const float* rw = rows + (it & 1) * 2 * kL;

    // s^T, dp^T: (key g (+8), query 8nt + 2t (+1) of the tile)
    float st[kL / 8][4] = {}, dpt[kL / 8][4] = {};
    {
      unsigned a[4][4];
      frags_a(a, Ks);
      product_rows<kL>(st, a, Qt);
      frags_a(a, Vs);
      product_rows<kL>(dpt, a, dOt);
    }
#pragma unroll
    for (int nt = 0; nt < kL / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + 2 * t + (e & 1);
        const float p = kv[e >> 1] ? gf::exp2_approx(fmaf(st[nt][e], scale2, -rw[i])) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - rw[kL + i]) * scale;  // ds
      }
    product_cols<kL>(dva, st, dOt);  // dv[j][d] += sum_i p[i][j] do[i][d]
    product_cols<kL>(dka, dpt, Qt);  // dk[j][d] += sum_i ds[i][j] q[i][d]
    if (it + 1 < tiles && tid < kL) {  // tile it - 1's values were read before the barrier
      float* nr = rows + ((it + 1) & 1) * 2 * kL;
      nr[tid] = rl;
      nr[kL + tid] = rd;
    }
  }
  gf::cp_async_wait<0>();  // nothing in flight when the block ends
  store_rows(dk + kb, dka, j0 + warp * 16, Nk, lk.row);
  store_rows(dv + kb, dva, j0 + warp * 16, Nk, lk.row);
}

// grid (ceil(Nq / kRows), H, S). The block owns queries [i0, i0 + kRows) and
// their dq; a warp owns 16 of them and keeps their Q and dO fragments in
// registers. Per key tile: s = Q K^T and dp = dO V^T as C fragments, ds in
// place, then dq += ds K. A key tile without a valid key is skipped.
__global__ void __launch_bounds__(Dq::kThreads, Dq::kBlocks) attn_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mq,
    const unsigned char* __restrict__ mk, bf16* __restrict__ dq,
    int Nq, int Nk, Lay lq, Lay lk, float scale) {
  constexpr int kR = Dq::kRows, kL = Dq::kLoop, kT = Dq::kThreads, kS = kStride;
  GF_DYN_SMEM(bf16, smem);
  bf16* Qs = smem;                 // [kR][kS]
  bf16* dOs = Qs + kR * kS;        // [kR][kS]
  bf16* Ks = dOs + kR * kS;        // [2][kL][kS]
  bf16* Vs = Ks + 2 * kL * kS;     // [2][kL][kS]
  unsigned char* kval = reinterpret_cast<unsigned char*>(Vs + 2 * kL * kS);  // [2][kL]

  const int s = blockIdx.z, h = blockIdx.y, H = gridDim.y, i0 = blockIdx.x * kR;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const size_t qb = s * lq.set + h * lq.head, kb = s * lk.set + h * lk.head;
  const size_t rb = ((size_t)s * H + h) * Nq;

  unsigned char kn = 0;  // thread tid < kL: key j valid
  auto key_valid = [&](int j) { kn = j < Nk && (mk == nullptr || mk[(size_t)s * Nk + j]); };
  auto stage_keys = [&](int it) {  // into stage it % 2 of the ring
    const int buf = it & 1;
    stage_bf16<kL, kT>(Ks + buf * kL * kS, k + kb, it * kL, Nk, lk.row);
    stage_bf16<kL, kT>(Vs + buf * kL * kS, v + kb, it * kL, Nk, lk.row);
  };
  stage_bf16<kR, kT>(Qs, q + qb, i0, Nq, lq.row);
  stage_bf16<kR, kT>(dOs, dout + qb, i0, Nq, lq.row);
  stage_keys(0);
  gf::cp_async_commit();
  if (tid < kL) {
    key_valid(tid);
    kval[tid] = kn;
  }
  // queries i0 + 16 warp + g (+8): lse log2(e) (+inf for a row that is
  // invalid or past the set: its p is then exactly 0) and delta
  float rl[2], rd[2];
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + g + 8 * r;
    const bool ok = i < Nq && (mq == nullptr || mq[(size_t)s * Nq + i]);
    rl[r] = ok ? lse[rb + i] * kLog2e : INFINITY;
    rd[r] = ok ? delta[rb + i] : 0.f;
  }
  gf::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[4][4], of[4][4];
  frags_a(qf, Qs);
  frags_a(of, dOs);

  float dqa[8][4] = {};  // (query g (+8), d 8nd + 2t (+1))
  const float scale2 = scale * kLog2e;
  const int tiles = (Nk + kL - 1) / kL;
  for (int it = 0; it < tiles; ++it) {
    gf::cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < tiles) {
      stage_keys(it + 1);  // into tile it - 1's stage
      if (tid < kL) key_valid((it + 1) * kL + tid);  // stored after this tile's products
    }
    gf::cp_async_commit();
    const bf16* Kt = Ks + (it & 1) * kL * kS;
    const bf16* Vt = Vs + (it & 1) * kL * kS;
    const unsigned char* kv = kval + (it & 1) * kL;
    // the tile's validity bytes, four a word: skip a tile without a valid
    // key, take it without masking when every key is valid
    unsigned any = 0, all = 1;
#pragma unroll
    for (int wd = 0; wd < kL / 4; ++wd) {
      const unsigned word = reinterpret_cast<const unsigned*>(kv)[wd];
      any |= word;
      all &= word == 0x01010101u;
    }
    if (any) {  // the same for the whole block
      unsigned bits = 0;  // bit 2nt + c: key 8nt + 2t + c of this lane's columns
#pragma unroll
      for (int nt = 0; nt < kL / 8; ++nt)
        bits |= (unsigned)(kv[nt * 8 + 2 * t] | kv[nt * 8 + 2 * t + 1] << 1) << (2 * nt);
      // s, dp: (query g (+8), key 8nt + 2t (+1) of the tile)
      float sa[kL / 8][4] = {}, dpa[kL / 8][4] = {};
      product_rows<kL>(sa, qf, Kt);
      product_rows<kL>(dpa, of, Vt);
#pragma unroll
      for (int nt = 0; nt < kL / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool valid = all || (bits >> (2 * nt + (e & 1)) & 1u);
          const float p = valid ? gf::exp2_approx(fmaf(sa[nt][e], scale2, -rl[r])) : 0.f;
          sa[nt][e] = p * (dpa[nt][e] - rd[r]) * scale;  // ds
        }
      product_cols<kL>(dqa, sa, Kt);  // dq[i][d] += sum_j ds[i][j] k[j][d]
    }
    if (it + 1 < tiles && tid < kL) kval[((it + 1) & 1) * kL + tid] = kn;
  }
  gf::cp_async_wait<0>();  // nothing in flight when the block ends
  store_rows(dq + qb, dqa, i0 + warp * 16, Nq, lq.row);
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
  constexpr bool f32 = std::is_same<T, float>::value;
  if constexpr (f32) {
    static cudaError_t attr_kv = gf::allow_smem(attn_bwd_dkv_kernel<T>, kDkvSmem);
    static cudaError_t attr_q = gf::allow_smem(attn_bwd_dq_kernel<T>, kDqSmem);
    if (attr_kv != cudaSuccess) return (int)attr_kv;
    if (attr_q != cudaSuccess) return (int)attr_q;
  } else {
    static cudaError_t attr_kv = gf::allow_smem(attn_bwd_dkv_bf16_kernel, kDkvBf16Smem);
    static cudaError_t attr_q = gf::allow_smem(attn_bwd_dq_bf16_kernel, kDqBf16Smem);
    if (attr_kv != cudaSuccess) return (int)attr_kv;
    if (attr_q != cudaSuccess) return (int)attr_q;
  }
  const size_t rows = (size_t)S * H * Nq, warps = kThreads / 32;
  if constexpr (f32) {
    GF_LAUNCH(attn_bwd_delta_kernel<T>, dim3((unsigned)((rows + warps - 1) / warps)), kThreads,
              0, st, (const T*)o, (const T*)dout, delta, S, Nq, lq, H);
    GF_LAUNCH(attn_bwd_dkv_kernel<T>, dim3((Nk + kTile - 1) / kTile, H, S), kThreads, kDkvSmem,
              st, (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
              (const float*)delta, mq, mk, (T*)dk, (T*)dv, Nq, Nk, lq, lk, scale);
    GF_LAUNCH(attn_bwd_dq_kernel<T>, dim3((Nq + kTile - 1) / kTile, H, S), kThreads, kDqSmem,
              st, (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
              (const float*)delta, mq, mk, (T*)dq, Nq, Nk, lq, lk, scale);
  } else {
    GF_LAUNCH(attn_bwd_delta_bf16_kernel, dim3((unsigned)((rows * 8 + kThreads - 1) / kThreads)),
              kThreads, 0, st, (const T*)o, (const T*)dout, delta, S, Nq, lq, H);
    GF_LAUNCH(attn_bwd_dkv_bf16_kernel, dim3((Nk + Dkv::kRows - 1) / Dkv::kRows, H, S),
              Dkv::kThreads, kDkvBf16Smem, st, (const T*)q, (const T*)k, (const T*)v,
              (const T*)dout, lse, (const float*)delta, mq, mk, (T*)dk, (T*)dv, Nq, Nk, lq, lk,
              scale);
    GF_LAUNCH(attn_bwd_dq_bf16_kernel, dim3((Nq + Dq::kRows - 1) / Dq::kRows, H, S),
              Dq::kThreads, kDqBf16Smem, st, (const T*)q, (const T*)k, (const T*)v,
              (const T*)dout, lse, (const float*)delta, mq, mk, (T*)dq, Nq, Nk, lq, lk, scale);
  }
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
