// Stand-in for the CUDA runtime header so that the port's kernel sources
// (gluefactory_tpu_torch/csrc/*.cu) compile with a host C++20 compiler and
// run on the CPU: every CUDA thread of a block is a fiber (ucontext) with a
// stack of its own, and one OS thread runs a block's fibers cooperatively,
// blocks one after another. __syncthreads is a barrier at which a fiber
// yields until the whole block has arrived; __shared__ variables are statics
// shared by the block's threads, and dynamic shared memory is one static
// buffer. Launches go through GF_LAUNCH (csrc/common.cuh), which this header
// defines first. Used by tests/test_torch_kernels_emulated.py with
//   g++ -std=c++20 -shared -fPIC -include cuda_runtime.h -I<this dir> -x c++ file.cu
// Warps: each 32 consecutive threads of a block share a barrier and a scratch
// area. The warp-level functions of csrc/mma.cuh (mma.sync, ldmatrix,
// cp.async, TF32 rounding) and __shfl_xor_sync are stand-ins here: every
// lane writes its operand to the scratch, waits at the warp's barrier, and
// computes its own result from the other lanes' operands, following the PTX
// ISA's fragment layouts. cp.async is a plain copy and its waits are no-ops
// (the kernels' __syncthreads order the copies as on the card). A kernel in
// which some threads of a block never reach a barrier that others wait at
// aborts with a message (on the card it would hang).
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx;  // the running fiber's
inline dim3 blockDim, gridDim;

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T>
inline cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return cudaSuccess; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x) alignas(x)

inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

// ------------------------------------------------------------- fibers
// A barrier of `expected` fibers: the last to arrive goes on, the others
// yield until its generation has moved.
struct gf_emu_bar {
  int expected = 0, arrived = 0;
  unsigned gen = 0;
};

struct gf_emu_warp;
struct gf_emu_fiber {
  ucontext_t ctx;
  dim3 tid;
  gf_emu_warp* warp;
  int lane;
  unsigned round;
  const gf_emu_bar* waits_on;  // with the generation it waits to see pass
  unsigned waits_gen;
  bool done;
};
inline ucontext_t gf_emu_sched;
inline gf_emu_fiber* gf_emu_cur = nullptr;

// Returns true to the fiber that arrived last: it runs on before any other
// fiber of the barrier resumes.
inline bool gf_emu_wait(gf_emu_bar& b) {
  const unsigned gen = b.gen;
  if (++b.arrived == b.expected) {
    b.arrived = 0;
    ++b.gen;
    return true;
  }
  gf_emu_cur->waits_on = &b;
  gf_emu_cur->waits_gen = gen;
  swapcontext(&gf_emu_cur->ctx, &gf_emu_sched);  // back once b.gen has moved
  return false;
}

inline gf_emu_bar* gf_emu_block_bar = nullptr;
inline void __syncthreads() { gf_emu_wait(*gf_emu_block_bar); }

// ------------------------------------------------------------------ warps
struct gf_emu_warp {
  explicit gf_emu_warp(int lanes) { bar.expected = lanes; }
  gf_emu_bar bar;
  // two rounds of 32 lanes x 32 bytes: a lane writes round r + 2 only after
  // every lane has passed the barrier of round r + 1, so done reading round r
  alignas(16) unsigned char slot[2][32][32];
  float res[2][32][4];  // an mma's results, by round, computed once for the warp
};
// the running fiber's warp, exchange round and lane
inline gf_emu_warp* gf_emu_this_warp = nullptr;
inline unsigned gf_emu_round = 0;
inline int gf_emu_lane = 0;

// Publish this lane's `mine`, wait for the warp; returns the round's slots.
// `last`, if given, is set for the lane that arrived last, which runs before
// the others read the round.
template <class T>
inline unsigned char (*gf_emu_exchange(const T& mine, bool* last = nullptr))[32] {
  static_assert(sizeof(T) <= 32, "a lane publishes at most 32 bytes");
  auto slots = gf_emu_this_warp->slot[gf_emu_round++ & 1];
  std::memcpy(slots[gf_emu_lane], &mine, sizeof(T));
  const bool l = gf_emu_wait(gf_emu_this_warp->bar);
  if (last) *last = l;
  return slots;
}
template <class T>
inline T gf_emu_from(unsigned char (*slots)[32], int lane) {
  T v;
  std::memcpy(&v, slots[lane], sizeof(T));
  return v;
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  return gf_emu_from<float>(gf_emu_exchange(v), gf_emu_lane ^ lane_mask);
}

#define GF_EMU_WARP 1
namespace gf {

inline float emu_bf16(unsigned v, int hi) {
  uint32_t u = (hi ? v >> 16 : v & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// D = A B of one warp into `res` (lane, c0..c3); A is 16 x K, B is K x 8
template <int K>
inline void emu_mma(float (*res)[4], const float (*A)[K], const float (*B)[8]) {
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >= 2), n = 2 * t + (e & 1);
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc += A[r][k] * B[k][n];
      res[lane][e] = acc;
    }
  }
}

// The lane that arrives last at the exchange computes the whole warp's
// product (the others resume only after it has); each lane adds its part.
inline void mma_bf16_m16n8k16(float d[4], const unsigned a[4], const unsigned b[2]) {
  struct Frag { unsigned a[4], b[2]; } mine{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}};
  bool last;
  auto slots = gf_emu_exchange(mine, &last);
  float (*res)[4] = gf_emu_this_warp->res[(gf_emu_round - 1) & 1];
  if (last) {
    // A(r, k) sits in lane (r % 8) * 4 + (k % 8) / 2, register (r >= 8) + 2 (k >= 8);
    // B(k, n) in lane n * 4 + (k % 8) / 2, register k >= 8; the half is k % 2
    float A[16][16], B[16][8];
    for (int lane = 0; lane < 32; ++lane) {
      Frag f = gf_emu_from<Frag>(slots, lane);
      const int g = lane >> 2, t = lane & 3;
      for (int h = 0; h < 2; ++h) {
        for (int reg = 0; reg < 4; ++reg)
          A[g + 8 * (reg & 1)][2 * t + h + 8 * (reg >> 1)] = emu_bf16(f.a[reg], h);
        for (int reg = 0; reg < 2; ++reg) B[2 * t + h + 8 * reg][g] = emu_bf16(f.b[reg], h);
      }
    }
    emu_mma<16>(res, A, B);
  }
  for (int e = 0; e < 4; ++e) d[e] += res[gf_emu_lane][e];
}

// cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away from zero
// (adding half a unit to the magnitude's bits carries into the exponent)
inline unsigned to_tf32(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return u;
}

// The value the tensor core reads from a .tf32 register: its top 19 bits.
inline float emu_tf32(unsigned v) { return __uint_as_float(v & 0xffffe000u); }

inline void mma_tf32_m16n8k8(float d[4], const unsigned a[4], const unsigned b[2]) {
  struct Frag { unsigned a[4], b[2]; } mine{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}};
  bool last;
  auto slots = gf_emu_exchange(mine, &last);
  float (*res)[4] = gf_emu_this_warp->res[(gf_emu_round - 1) & 1];
  if (last) {
    // A(r, k) sits in lane (r % 8) * 4 + k % 4, register (r >= 8) + 2 (k >= 4);
    // B(k, n) in lane n * 4 + k % 4, register k >= 4
    float A[16][8], B[8][8];
    for (int lane = 0; lane < 32; ++lane) {
      Frag f = gf_emu_from<Frag>(slots, lane);
      const int g = lane >> 2, t = lane & 3;
      for (int reg = 0; reg < 4; ++reg)
        A[g + 8 * (reg & 1)][t + 4 * (reg >> 1)] = emu_tf32(f.a[reg]);
      for (int reg = 0; reg < 2; ++reg) B[t + 4 * reg][g] = emu_tf32(f.b[reg]);
    }
    emu_mma<8>(res, A, B);
  }
  for (int e = 0; e < 4; ++e) d[e] += res[gf_emu_lane][e];
}

// lane l names row l % 8 of matrix l / 8
inline void emu_ldsm(unsigned r[4], const void* row, bool trans) {
  auto slots = gf_emu_exchange(row);
  const int g = gf_emu_lane >> 2, t = gf_emu_lane & 3;
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (trans) {  // (rows 2t, 2t+1; col g)
      lo = gf_emu_from<const uint16_t*>(slots, j * 8 + 2 * t)[g];
      hi = gf_emu_from<const uint16_t*>(slots, j * 8 + 2 * t + 1)[g];
    } else {  // (row g; cols 2t, 2t+1)
      const uint16_t* p = gf_emu_from<const uint16_t*>(slots, j * 8 + g);
      lo = p[2 * t];
      hi = p[2 * t + 1];
    }
    r[j] = (unsigned)lo | ((unsigned)hi << 16);
  }
}
inline void ldsm_x4(unsigned r[4], const void* row) { emu_ldsm(r, row, false); }
inline void ldsm_x4_trans(unsigned r[4], const void* row) { emu_ldsm(r, row, true); }

inline void cp_async16(void* dst, const void* src, bool in) {
  if (in)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int n>
inline void cp_async_wait() {}

// ex2.approx.ftz: a subnormal result is flushed to 0
inline float exp2_approx(float x) {
  const float y = std::exp2(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}

}  // namespace gf

alignas(16) inline unsigned char gf_emu_smem[232448];
#define GF_DYN_SMEM(type, name) type* name = reinterpret_cast<type*>(gf_emu_smem)

inline const std::function<void()>* gf_emu_body = nullptr;
inline void gf_emu_fiber_main() {
  (*gf_emu_body)();
  gf_emu_cur->done = true;  // returns to the scheduler (uc_link)
}

inline void gf_emu_launch(dim3 grid, dim3 block, const std::function<void()>& body) {
  constexpr size_t kStack = 256 << 10;  // a fiber's stack (pages are touched as used)
  gridDim = grid;
  blockDim = block;
  gf_emu_body = &body;
  const int nt = block.x * block.y * block.z;
  std::vector<gf_emu_fiber> fibers(nt);
  std::unique_ptr<char[]> stacks(new char[kStack * nt]);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        gf_emu_bar bar;
        bar.expected = nt;
        gf_emu_block_bar = &bar;
        std::vector<std::unique_ptr<gf_emu_warp>> warps;
        for (int w = 0; w * 32 < nt; ++w)
          warps.push_back(std::make_unique<gf_emu_warp>(std::min(32, nt - w * 32)));
        blockIdx = dim3(bx, by, bz);
        for (int t = 0; t < nt; ++t) {
          gf_emu_fiber& f = fibers[t];
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = stacks.get() + kStack * t;
          f.ctx.uc_stack.ss_size = kStack;
          f.ctx.uc_link = &gf_emu_sched;
          makecontext(&f.ctx, gf_emu_fiber_main, 0);
          f.tid = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
          f.warp = warps[t / 32].get();
          f.lane = t % 32;
          f.round = 0;
          f.waits_on = nullptr;
          f.done = false;
        }
        // resume every fiber that can go on, in turn, until all have returned
        for (int live = nt; live > 0;) {
          bool moved = false;
          for (gf_emu_fiber& f : fibers) {
            if (f.done || (f.waits_on && f.waits_on->gen == f.waits_gen)) continue;
            f.waits_on = nullptr;
            gf_emu_cur = &f;
            threadIdx = f.tid;
            gf_emu_this_warp = f.warp;
            gf_emu_lane = f.lane;
            gf_emu_round = f.round;
            swapcontext(&gf_emu_sched, &f.ctx);
            f.round = gf_emu_round;
            live -= f.done;
            moved = true;
          }
          if (!moved) {
            std::fprintf(stderr, "cuda_emu: block (%u, %u, %u) deadlocked at a barrier\n", bx,
                         by, bz);
            std::abort();
          }
        }
      }
}

#define GF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  gf_emu_launch(dim3(grid), dim3(block), [&] { kernel(__VA_ARGS__); })
