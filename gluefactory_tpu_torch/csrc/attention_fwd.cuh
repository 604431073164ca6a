// Forward attention tile shared by the block kernels (lightglue_block.cu)
// and the training attention kernels (attention.cu): one 64-query tile of
// one head against a whole key set, online softmax over 64-key tiles, on the
// packed layout (a head is a 64-channel slice of a row of `ld` channels).
//
// Masking semantics are those of the plain versions in ops/attention.py: a
// masked key has weight exactly 0; a query row that is invalid, or that sees
// no valid key, gets an exact zero row.
#pragma once

#include "common.cuh"

namespace gf {

constexpr int kAttnThreads = 256;
constexpr int kAttnTile = 64;  // queries and keys of one tile
constexpr int kAttnPad = 68;   // padded row length of the 64-wide tiles
constexpr int kAttnDh = 64;    // head width
// Qs, Ks, Vs, Ps (64 x kAttnPad each), red (64 x 17), kvalid (64)
constexpr int kAttnFwdSmem =
    (4 * kAttnTile * kAttnPad + kAttnTile * 17 + kAttnTile) * sizeof(float);

// q, out: row i of this set and head at [i * ld]; k, v: row j at [j * ld];
// mq (nq) and mk (nk) are validity bytes or null; lse (nq) is null or
// receives the row's log-sum-exp of the scaled logits (0 for a zero row),
// which the backward uses to rebuild the probabilities.
template <class T>
__device__ void attn_fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* mq,
                              const unsigned char* mk, T* __restrict__ out,
                              float* lse, int nq, int nk, int ld, int i0,
                              float scale, float* smem) {
  constexpr int kTile = kAttnTile, kPad = kAttnPad, kDh = kAttnDh;
  float(*Qs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem);                     // [d][r]
  float(*Ks)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + kTile * kPad);      // [d][c]
  float(*Vs)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 2 * kTile * kPad);  // [j][c]
  float(*Ps)[kPad] = reinterpret_cast<float(*)[kPad]>(smem + 3 * kTile * kPad);  // [j][r]
  float(*red)[17] = reinterpret_cast<float(*)[17]>(smem + 4 * kTile * kPad);
  float* kvalid = smem + 4 * kTile * kPad + kTile * 17;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = 0; e < kTile * kDh / kAttnThreads; ++e) {
    int idx = tid + e * kAttnThreads;
    int r = idx / kDh, d = idx % kDh;
    int gi = i0 + r;
    Qs[d][r] = gi < nq ? to_f(q[(size_t)gi * ld + d]) : 0.f;
  }
  bool qv[4];
  for (int i = 0; i < 4; ++i) {
    int gi = i0 + ty * 4 + i;
    qv[i] = gi < nq && (mq == nullptr || mq[gi]);
  }

  const float kNone = -1e30f;
  float m[4], l[4], o[4][4] = {};
  for (int i = 0; i < 4; ++i) { m[i] = kNone; l[i] = 0.f; }

  for (int j0 = 0; j0 < nk; j0 += kTile) {
    __syncthreads();
    for (int e = 0; e < kTile * kDh / kAttnThreads; ++e) {
      int idx = tid + e * kAttnThreads;
      int c = idx / kDh, d = idx % kDh;
      int gj = j0 + c;
      bool in = gj < nk;
      Ks[d][c] = in ? to_f(k[(size_t)gj * ld + d]) : 0.f;
      Vs[c][d] = in ? to_f(v[(size_t)gj * ld + d]) : 0.f;
    }
    if (tid < kTile) {
      int gj = j0 + tid;
      kvalid[tid] = (gj < nk && (mk == nullptr || mk[gj])) ? 1.f : 0.f;
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
    if (gi >= nq) continue;
    bool live = qv[i] && l[i] > 0.f;
    float inv = live ? 1.f / l[i] : 0.f;
    for (int j = 0; j < 4; ++j)
      out[(size_t)gi * ld + tx * 4 + j] = from_f<T>(o[i][j] * inv);
    if (lse != nullptr && tx == 0) lse[gi] = live ? m[i] + logf(l[i]) : 0.f;
  }
}

}  // namespace gf
