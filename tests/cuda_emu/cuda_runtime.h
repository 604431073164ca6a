// Stand-in for the CUDA runtime header so that the port's kernel sources
// (gluefactory_tpu_torch/csrc/*.cu) compile with a host C++20 compiler and
// run on the CPU: every CUDA thread of a block is a std::thread, blocks run
// one after another, __syncthreads is a std::barrier, __shared__ variables
// are statics shared by the block's threads, and dynamic shared memory is one
// static buffer. Launches go through GF_LAUNCH (csrc/common.cuh), which this
// header defines first. Used by tests/test_torch_kernels_emulated.py with
//   g++ -std=c++20 -shared -fPIC -include cuda_runtime.h -I<this dir> -x c++ file.cu
// Warps: each 32 consecutive threads of a block share a std::barrier and a
// scratch area. The warp-level functions of csrc/mma.cuh (mma.sync,
// ldmatrix, cp.async) and __shfl_xor_sync are stand-ins here: every lane
// writes its operand to the scratch, waits at the warp's barrier, and
// computes its own result from the other lanes' operands, following the
// PTX ISA's fragment layouts. cp.async is a plain copy and its waits are
// no-ops (the kernels' __syncthreads order the copies as on the card).
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct alignas(16) float4 {
  float x, y, z, w;
};

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

inline std::barrier<>* gf_emu_barrier = nullptr;
inline void __syncthreads() { gf_emu_barrier->arrive_and_wait(); }

// ------------------------------------------------------------------ warps
struct gf_emu_warp {
  explicit gf_emu_warp(int lanes) : bar(lanes) {}
  std::barrier<> bar;
  // two rounds of 32 lanes x 32 bytes: a lane writes round r + 2 only after
  // every lane has passed the barrier of round r + 1, so done reading round r
  alignas(16) unsigned char slot[2][32][32];
};
inline thread_local gf_emu_warp* gf_emu_this_warp = nullptr;
inline thread_local unsigned gf_emu_round = 0;
inline thread_local int gf_emu_lane = 0;

// Publish this lane's `mine`, wait for the warp; returns the round's slots.
template <class T>
inline unsigned char (*gf_emu_exchange(const T& mine))[32] {
  static_assert(sizeof(T) <= 32, "a lane publishes at most 32 bytes");
  auto slots = gf_emu_this_warp->slot[gf_emu_round++ & 1];
  std::memcpy(slots[gf_emu_lane], &mine, sizeof(T));
  gf_emu_this_warp->bar.arrive_and_wait();
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

inline void mma_bf16_m16n8k16(float d[4], const unsigned a[4], const unsigned b[2]) {
  struct Frag { unsigned a[4], b[2]; } mine{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}};
  auto slots = gf_emu_exchange(mine);
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
  const int g = gf_emu_lane >> 2, t = gf_emu_lane & 3;
  for (int e = 0; e < 4; ++e) {
    int r = g + 8 * (e >= 2), n = 2 * t + (e & 1);
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) acc += A[r][k] * B[k][n];
    d[e] += acc;
  }
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

}  // namespace gf

alignas(16) inline unsigned char gf_emu_smem[232448];
#define GF_DYN_SMEM(type, name) type* name = reinterpret_cast<type*>(gf_emu_smem)

inline void gf_emu_launch(dim3 grid, dim3 block, const std::function<void()>& body) {
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        gf_emu_barrier = &bar;
        std::vector<std::unique_ptr<gf_emu_warp>> warps;
        for (int w = 0; w * 32 < nt; ++w)
          warps.push_back(std::make_unique<gf_emu_warp>(std::min(32, nt - w * 32)));
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            gf_emu_this_warp = warps[t / 32].get();
            gf_emu_lane = t % 32;
            gf_emu_round = 0;
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            body();
          });
        for (auto& th : threads) th.join();
      }
}

#define GF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  gf_emu_launch(dim3(grid), dim3(block), [&] { kernel(__VA_ARGS__); })
