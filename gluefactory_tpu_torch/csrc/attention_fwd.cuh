// Forward attention tile shared by the block kernels (lightglue_block.cu)
// and the training attention kernels (attention.cu): one 64-query tile of
// one head against a whole key set, online softmax over 64-key tiles, on the
// packed layout (a head is a 64-channel slice of a row of `ld` channels).
//
// Masking semantics are those of the plain versions in ops/attention.py: a
// masked key has weight exactly 0; a query row that is invalid, or that sees
// no valid key, gets an exact zero row.
//
// On the tensor cores at fp32 accuracy (FlashAttention-2 form): 4 warps, a
// warp owns 16 of the tile's queries and keeps their Q fragments, split into
// TF32 hi and lo (gf::split_tf32), in registers for the whole key loop.
// S = Q K^T and O += P V run on mma.sync m16n8k8 in three passes (lo.hi +
// hi.lo + hi.hi, gf::mma_split); S stays in registers as C fragments, the
// online max and sum run there with quad shuffles, and P goes to the P V
// product as A fragments in the permuted contraction order (gf::frag_c),
// so it never leaves registers. K and V tiles are fp32 in shared memory at
// row stride 68 (K read by ldmatrix, V down its columns by conflict-free
// scalar loads), double-buffered: fp32 by cp.async, bf16 by loads that
// widen. bf16 data is exact in TF32, so the bf16 instantiation leaves out
// the passes that multiply a zero lo part: one for S, two for P V (P is
// fp32). Masked keys are not read (their rows are zero-filled), and a key
// tile without a valid key is skipped, so padding at the end of a set costs
// no product.
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

// Rows [r0, r0 + rows) of one head (row stride ld) into dst[r][0..64) at
// row stride kAttnPad, in fp32; rows from n on, and rows whose `valid` byte
// is 0, are zero. fp32 goes by cp.async (the caller commits and waits),
// bf16 by loads that widen.
template <int rows, class T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int r0, int n,
                                           int ld, const unsigned char* valid = nullptr) {
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < rows * kAttnDh / 4; e += kAttnThreads) {
      const int r = e / (kAttnDh / 4), c = e % (kAttnDh / 4) * 4;
      const bool in = r0 + r < n && (valid == nullptr || valid[r0 + r]);
      cp_async16(dst + r * kAttnPad + c, in ? src + (size_t)(r0 + r) * ld + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kAttnDh; e += kAttnThreads) {
      const int r = e / kAttnDh, d = e % kAttnDh;
      const bool in = r0 + r < n && (valid == nullptr || valid[r0 + r]);
      dst[r * kAttnPad + d] = in ? to_f(src[(size_t)(r0 + r) * ld + d]) : 0.f;
    }
  }
}

// q, out: row i of this set and head at [i * ld]; k, v: row j at [j * ld];
// mq (nq) and mk (nk) are validity bytes or null; lse (nq) is null or
// receives the row's log-sum-exp of the scaled logits (0 for a zero row),
// which the backward uses to rebuild the probabilities. Every thread of the
// block calls it with the same arguments; rows are 16-byte aligned.
template <class T>
__device__ void attn_fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* mq,
                              const unsigned char* mk, T* __restrict__ out,
                              float* lse, int nq, int nk, int ld, int i0,
                              float scale, float* smem) {
  constexpr bool kExact = !std::is_same<T, float>::value;  // no lo parts in Q, K, V
  constexpr int kTile = kAttnTile, kPad = kAttnPad, kTileF = kAttnTileF;
  float* Ks = smem;                  // [2][key][d]; Q in the second buffer at first
  float* Vs = smem + 2 * kTileF;     // [2][key][d]
  unsigned char* kval = reinterpret_cast<unsigned char*>(smem + 4 * kTileF);  // [2][key]
  const int tid = threadIdx.x, m0 = tid / 32 * 16, g = tid % 32 / 4, t = tid % 4;

  auto stage_keys = [&](int jt) {
    const int buf = jt & 1, j0 = jt * kTile;
    stage_rows<kTile, T>(Ks + buf * kTileF, k, j0, nk, ld, mk);
    stage_rows<kTile, T>(Vs + buf * kTileF, v, j0, nk, ld, mk);
    if (tid < kTile) {
      const int j = j0 + tid;
      kval[buf * kTile + tid] = j < nk && (mk == nullptr || mk[j]);
    }
    cp_async_commit();
  };
  stage_rows<kTile, T>(Ks + kTileF, q, i0, nq, ld);
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
        mma_split<kExact, kExact>(sc[ni], qh[ks], ql[ks], bh, bl);
        mma_split<kExact, kExact>(sc[ni + 1], qh[ks], ql[ks], bh + 2, bl + 2);
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
        mma_split<false, kExact>(o[nd], ph, pl, bh, bl);  // o[i][d] += sum_j p[i][j] v[j][d]
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

}  // namespace gf
