// Forward attention tile shared by the block kernels (lightglue_block.cu)
// and the training attention kernels (attention.cu): one tile of queries of
// one head against a whole key set, online softmax over key tiles, on the
// packed layout (a head is a 64-channel slice of a row of `ld` channels).
//
// Masking semantics are those of the plain versions in ops/attention.py: a
// masked key has weight exactly 0; a query row that is invalid, or that sees
// no valid key, gets an exact zero row. A key tile without a valid key is
// skipped, so padding at the end of a set costs no product.
//
// fp32 (attn_fwd_tile<float>): on the tensor cores at fp32 accuracy
// (FlashAttention-2 form): 4 warps, a warp owns 16 of the tile's 64 queries
// and keeps their Q fragments, split into TF32 hi and lo (gf::split_tf32),
// in registers for the whole key loop. S = Q K^T and O += P V run on
// mma.sync m16n8k8 in three passes (lo.hi + hi.lo + hi.hi, gf::mma_split);
// S stays in registers as C fragments, the online max and sum run there
// with quad shuffles, and P goes to the P V product as A fragments in the
// permuted contraction order (gf::frag_c), so it never leaves registers. K
// and V tiles are fp32 in shared memory at row stride 68 (K read by
// ldmatrix, V down its columns by conflict-free scalar loads),
// double-buffered by cp.async; masked keys are not read (zero-filled).
//
// bf16 (attn_fwd_tile<__nv_bfloat16>): the same online softmax on bf16
// operands in FwdTile<__nv_bfloat16>'s block: 8 warps of 16 queries (128 a
// block), 64-key tiles, 55,424 bytes of shared memory, at most 128
// registers (two blocks a multiprocessor, no spills). It replaces the bf16
// forms of the Pallas kernels _attention_kernel_packed and
// _bidir_cross_kernel_packed (gluefactory_tpu/ops/pallas_attention.py:319,
// :600; K5 and K6b of a `mp: True` training step, K6a, K7a and K7c in bf16)
// and serves the LightGlue blocks' bf16 attention. Before it, bf16 ran the
// fp32 tile, which widened its tiles to fp32 by one synchronous 2-byte load
// an element (its double buffer overlapped nothing) and ran TF32 passes on
// the widened data (half the bf16 rate and depth an instruction). Here Q, K
// and V are bf16 in shared memory at row stride 72 (144 bytes: the eight
// rows of an ldmatrix on distinct banks), filled by 16-byte cp.async; the
// key tiles sit in a two-stage ring, tile jt + 1's copy in flight while
// tile jt's products run. S = Q K^T and O += P V are mma.sync m16n8k16 (bf16
// in, fp32 accumulators), one pass each; Q and K are read by ldmatrix, V by
// ldmatrix.trans. P is rounded to bf16 in registers as the A operand of
// P V (the C fragments of two n8 tiles are an m16n8k16 A fragment), as the
// Pallas kernels round e.astype(v.dtype) (:354, :637), while the row sums
// add the fp32 p, as their `denom` does; O stays fp32 and is rounded once,
// at the store. Choices timed by scripts/torch_fwd_k4_variants.py at the
// training step's shape: Q's fragments are read again at every key tile (4
// of a warp's 36 ldmatrix a tile), because kept in registers they spill at
// the cap of 128 and run 3-6% slower; exp2 is ex2.approx (2^-22 relative
// error, far below P's bf16 rounding), as exp2f runs 10-13% slower; rows
// past the set are zero-filled but masked keys are read and weighted 0,
// as zero-filling them by their mask bytes runs 3-6% slower; 64 queries a
// block run no faster, 128-key tiles slower. At a training step's (64,
// 512, 256) the bound is 0.0202 ms of bytes (q, k, v, out in bf16 at 3.35
// TB/s) against 17 GFLOP / 989 TFLOP/s = 0.017 ms. wgmma waits:
// tests/cuda_emu cannot model its shared-memory descriptors, and mma.sync
// already beats the serving tile this one replaced.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace gf {

constexpr int kAttnThreads = 128;  // 4 warps of 16 queries
constexpr int kAttnTile = 64;      // queries of a block, keys of a loop step
constexpr int kAttnPad = 68;       // row stride of the fp32 tiles in shared memory
constexpr int kAttnDh = 64;        // head width
constexpr int kAttnTileF = kAttnTile * kAttnPad;
// K and V of two key tiles (Q is staged in the second K buffer before the
// loop) and the validity bytes of two key tiles: 69,760 bytes, three blocks
// a multiprocessor
constexpr int kAttnFwdSmem = 4 * kAttnTileF * (int)sizeof(float) + 2 * kAttnTile;

// The forward tile's block for element type T: threads, queries a block (the
// grid's x extent is ceil(Nq / kQueries)), dynamic shared memory in bytes and
// the blocks a multiprocessor that the kernels' __launch_bounds__ ask for.
template <class T>
struct FwdTile;
template <>
struct FwdTile<float> {
  static constexpr int kThreads = kAttnThreads, kQueries = kAttnTile, kSmem = kAttnFwdSmem;
  static constexpr int kBlocks = 3;  // a cap of 168 registers
};
template <>
struct FwdTile<__nv_bfloat16> {
  static constexpr int kQueries = 128;           // 8 warps of 16 queries
  static constexpr int kKeys = 64;               // keys a loop step
  static constexpr int kStride = kAttnDh + 8;    // row stride of the bf16 tiles
  static constexpr int kThreads = 2 * kQueries;  // a warp for every 16 queries
  // Q, K and V of two key tiles, the validity bytes of two key tiles:
  // 55,424 bytes
  static constexpr int kSmem = (kQueries + 4 * kKeys) * kStride * 2 + 2 * kKeys;
  static constexpr int kBlocks = 2;  // a cap of 128 registers
};

// Rows [r0, r0 + rows) of one head (row stride ld) into dst[r][0..64) at
// row stride kAttnPad, in fp32, by cp.async (the caller commits and waits);
// rows from n on, and rows whose `valid` byte is 0, are zero.
template <int rows>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0,
                                           int n, int ld, const unsigned char* valid = nullptr) {
  for (int e = threadIdx.x; e < rows * kAttnDh / 4; e += kAttnThreads) {
    const int r = e / (kAttnDh / 4), c = e % (kAttnDh / 4) * 4;
    const bool in = r0 + r < n && (valid == nullptr || valid[r0 + r]);
    cp_async16(dst + r * kAttnPad + c, in ? src + (size_t)(r0 + r) * ld + c : src, in);
  }
}

// q, out: row i of this set and head at [i * ld]; k, v: row j at [j * ld];
// mq (nq) and mk (nk) are validity bytes or null; lse (nq) is null or
// receives the row's log-sum-exp of the scaled logits (0 for a zero row),
// which the backward uses to rebuild the probabilities. Queries [i0, i0 +
// FwdTile<T>::kQueries); every thread of the block calls it with the same
// arguments; rows are 16-byte aligned; smem holds FwdTile<T>::kSmem bytes.
template <class T>
__device__ void attn_fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* mq,
                              const unsigned char* mk, T* __restrict__ out,
                              float* lse, int nq, int nk, int ld, int i0,
                              float scale, float* smem) {
  static_assert(std::is_same<T, float>::value, "bf16 has its own tile below");
  constexpr int kTile = kAttnTile, kPad = kAttnPad, kTileF = kAttnTileF;
  float* Ks = smem;                  // [2][key][d]; Q in the second buffer at first
  float* Vs = smem + 2 * kTileF;     // [2][key][d]
  unsigned char* kval = reinterpret_cast<unsigned char*>(smem + 4 * kTileF);  // [2][key]
  const int tid = threadIdx.x, m0 = tid / 32 * 16, g = tid % 32 / 4, t = tid % 4;

  auto stage_keys = [&](int jt) {
    const int buf = jt & 1, j0 = jt * kTile;
    stage_rows<kTile>(Ks + buf * kTileF, k, j0, nk, ld, mk);
    stage_rows<kTile>(Vs + buf * kTileF, v, j0, nk, ld, mk);
    if (tid < kTile) {
      const int j = j0 + tid;
      kval[buf * kTile + tid] = j < nk && (mk == nullptr || mk[j]);
    }
    cp_async_commit();
  };
  stage_rows<kTile>(Ks + kTileF, q, i0, nq, ld);
  stage_keys(0);

  const float kNone = -1e30f, scale_log2 = scale * 1.4426950408889634f;
  unsigned qh[8][4], ql[8][4];  // this warp's 16 x 64 queries, eight k8 steps
  // rows g (r = 0) and g + 8 (r = 1): running max m and lane-partial sum l
  // (logits in log2 units), context o (columns 8 nd + 2t, + 1)
  float o[8][4] = {}, m[2] = {kNone, kNone}, l[2] = {0.f, 0.f};
  const int tiles = (nk + kTile - 1) / kTile;
  for (int jt = 0; jt < tiles; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with tile jt - 1
    if (jt == 0) {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) frag_a<kPad>(qh[ks], ql[ks], Ks + kTileF, m0, 8 * ks);
      __syncthreads();  // Q is read before tile 1 takes its buffer
    }
    if (jt + 1 < tiles) stage_keys(jt + 1);
    const float* Kt = Ks + (jt & 1) * kTileF;
    const float* Vt = Vs + (jt & 1) * kTileF;
    const unsigned char* kv = kval + (jt & 1) * kTile;
    // the tile's validity bytes, four a word: skip a tile without a valid key,
    // take it without masking when every key is valid
    unsigned any = 0, all = 1;
#pragma unroll
    for (int wd = 0; wd < kTile / 4; ++wd) {
      const unsigned word = reinterpret_cast<const unsigned*>(kv)[wd];
      any |= word;
      all &= word == 0x01010101u;
    }
    if (!any) continue;  // the same for the whole block
    unsigned bits = 0;  // bit 2ni + c: key 8ni + 2t + c of this lane's columns
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      bits |= (unsigned)(kv[ni * 8 + 2 * t] | kv[ni * 8 + 2 * t + 1] << 1) << (2 * ni);

    float sc[8][4] = {};  // 16 queries x 64 keys: (row g (+8), key 8ni + 2t (+1))
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        unsigned bh[4], bl[4];
        frag_b_rows<kPad>(bh, bl, Kt, 8 * ni, 8 * ks);
        mma_tf32x3(sc[ni], qh[ks], ql[ks], bh, bl);
        mma_tf32x3(sc[ni + 1], qh[ks], ql[ks], bh + 2, bl + 2);
      }
    // logits in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = all || (bits >> (2 * ni + (e & 1)) & 1u);
        const float val = valid ? sc[ni][e] * scale_log2 : kNone;
        sc[ni][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 1));
      mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[ni][e] *= alpha[e / 2];
        const bool valid = all || (bits >> (2 * ni + (e & 1)) & 1u);
        const float p = valid ? exp2f(sc[ni][e] - m[e / 2]) : 0.f;
        sc[ni][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // keys 8kk..8kk+7
      unsigned ph[4], pl[4];
      frag_c(ph, pl, sc[kk]);
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        unsigned bh[2], bl[2];
        frag_b_cols<kPad>(bh, bl, Vt, 8 * kk, 8 * nd);
        mma_tf32x3(o[nd], ph, pl, bh, bl);  // o[i][d] += sum_j p[i][j] v[j][d]
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += shfl_xor(lr, 1);
    lr += shfl_xor(lr, 2);
    const int gi = i0 + m0 + g + 8 * r;
    if (gi >= nq) continue;
    const bool live = (mq == nullptr || mq[gi]) && lr > 0.f;
    const float inv = live ? 1.f / lr : 0.f;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      store2(out + (size_t)gi * ld + 8 * nd + 2 * t, o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[gi] = live ? m[r] * 0.6931471805599453f + logf(lr) : 0.f;
  }
}


// The bf16 tile (see the note at the top); the arguments as above.
template <>
inline __device__ void attn_fwd_tile<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const unsigned char* mq, const unsigned char* mk,
    __nv_bfloat16* __restrict__ out, float* lse, int nq, int nk, int ld, int i0, float scale,
    float* smem) {
  using bf16 = __nv_bfloat16;
  using Tile = FwdTile<bf16>;
  constexpr int kQ = Tile::kQueries, kKT = Tile::kKeys, kS = Tile::kStride;
  constexpr int kThreads = Tile::kThreads;
  static_assert(kQ * 8 % kThreads == 0 && kKT * 8 % kThreads == 0,
                "16-byte pieces split evenly among the threads");
  static_assert(kKT == 64, "o is rescaled in the loop over the 8 key columns of a tile");
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kQ][kS]
  bf16* Ks = Qs + kQ * kS;                   // [2][kKT][kS]
  bf16* Vs = Ks + 2 * kKT * kS;              // [2][kKT][kS]
  unsigned char* kval = reinterpret_cast<unsigned char*>(Vs + 2 * kKT * kS);  // [2][kKT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  // rows of 64 bf16 as eight 16-byte pieces; out-of-range rows are
  // zero-filled (offsets fit an int: rows x ld < 2^31)
  for (int e = 0; e < kQ * 8 / kThreads; ++e) {
    const int idx = tid + e * kThreads, r = idx / 8, c = idx % 8 * 8;
    const bool in = i0 + r < nq;
    cp_async16(Qs + r * kS + c, q + (size_t)(in ? i0 + r : 0) * ld + c, in);
  }
  auto stage_keys = [&](int jt) {  // into stage jt % 2 of the ring
    const int buf = jt & 1, j0 = jt * kKT;
    for (int e = 0; e < kKT * 8 / kThreads; ++e) {
      const int idx = tid + e * kThreads, r = idx / 8, c = idx % 8 * 8, j = j0 + r;
      const bool in = j < nk;
      const int at = (in ? j : 0) * ld + c;
      cp_async16(Ks + (buf * kKT + r) * kS + c, k + at, in);
      cp_async16(Vs + (buf * kKT + r) * kS + c, v + at, in);
    }
    for (int r = tid; r < kKT; r += kThreads) {
      const int j = j0 + r;
      kval[buf * kKT + r] = j < nk && (mk == nullptr || mk[j]);
    }
  };
  stage_keys(0);
  cp_async_commit();

  const float kNone = -1e30f, scale_log2 = scale * 1.4426950408889634f;
  // rows g (r = 0) and g + 8 (r = 1): running max m and lane-partial sum l
  // (logits in log2 units), context o (columns 8 nd + 2t, + 1)
  float o[8][4] = {}, m[2] = {kNone, kNone}, l[2] = {0.f, 0.f};
  const int tiles = (nk + kKT - 1) / kKT;
  for (int jt = 0; jt < tiles; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with tile jt - 1
    if (jt + 1 < tiles) stage_keys(jt + 1);  // into tile jt - 1's stage
    cp_async_commit();
    const bf16* Kt = Ks + (jt & 1) * kKT * kS;
    const bf16* Vt = Vs + (jt & 1) * kKT * kS;
    const unsigned char* kv = kval + (jt & 1) * kKT;
    // the tile's validity bytes, four a word: skip a tile without a valid key,
    // take it without masking when every key is valid
    unsigned any = 0, all = 1;
#pragma unroll
    for (int wd = 0; wd < kKT / 4; ++wd) {
      const unsigned word = reinterpret_cast<const unsigned*>(kv)[wd];
      any |= word;
      all &= word == 0x01010101u;
    }
    if (!any) continue;  // the same for the whole block
    unsigned bits = 0;  // bit 2ni + c: key 8ni + 2t + c of this lane's columns
#pragma unroll
    for (int ni = 0; ni < kKT / 8; ++ni)
      bits |= (unsigned)(kv[ni * 8 + 2 * t] | kv[ni * 8 + 2 * t + 1] << 1) << (2 * ni);

    float sc[kKT / 8][4] = {};  // 16 queries x kKT keys: (row g (+8), key 8ni + 2t (+1))
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned qa[4];  // this warp's 16 queries, dims 16kk..
      ldsm_x4(qa, Qs + (warp * 16 + lane % 16) * kS + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int nj = 0; nj < kKT / 16; ++nj) {
        unsigned b[4];  // keys 16nj.. as two n8 tiles, dims 16kk..
        ldsm_x4(b, Kt + (nj * 16 + lane / 16 * 8 + lane % 8) * kS + kk * 16 + lane / 8 % 2 * 8);
        mma_bf16_m16n8k16(sc[2 * nj], qa, b);
        mma_bf16_m16n8k16(sc[2 * nj + 1], qa, b + 2);
      }
    }
    // logits in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < kKT / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = all || (bits >> (2 * ni + (e & 1)) & 1u);
        const float val = valid ? sc[ni][e] * scale_log2 : kNone;
        sc[ni][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 1));
      mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 2));
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int ni = 0; ni < kKT / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[ni][e] *= alpha[e / 2];  // in this loop: no spills at 128 registers
        const bool valid = all || (bits >> (2 * ni + (e & 1)) & 1u);
        const float p = valid ? exp2_approx(sc[ni][e] - m[e / 2]) : 0.f;
        sc[ni][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {  // keys 16kk..16kk+15
      // P rounded to bf16: the C fragments of keys 16kk.. and 16kk + 8.. as
      // one A fragment
      const unsigned pf[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < 4; ++dj) {
        unsigned b[4];  // keys 16kk.., dims 16dj.. as two n8 tiles
        ldsm_x4_trans(b, Vt + (kk * 16 + lane / 8 % 2 * 8 + lane % 8) * kS + dj * 16 +
                             lane / 16 * 8);
        mma_bf16_m16n8k16(o[2 * dj], pf, b);  // o[i][d] += sum_j p[i][j] v[j][d]
        mma_bf16_m16n8k16(o[2 * dj + 1], pf, b + 2);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += shfl_xor(lr, 1);
    lr += shfl_xor(lr, 2);
    const int gi = i0 + warp * 16 + g + 8 * r;
    if (gi >= nq) continue;
    const bool live = (mq == nullptr || mq[gi]) && lr > 0.f;
    const float inv = live ? 1.f / lr : 0.f;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      store2(out + (size_t)gi * ld + 8 * nd + 2 * t, o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[gi] = live ? m[r] * 0.6931471805599453f + logf(lr) : 0.f;
  }
}

}  // namespace gf
