// Stand-in for the CUDA runtime header so that the port's kernel sources
// (gluefactory_tpu_torch/csrc/*.cu) compile with a host C++20 compiler and
// run on the CPU: every CUDA thread of a block is a std::thread, blocks run
// one after another, __syncthreads is a std::barrier, __shared__ variables
// are statics shared by the block's threads, and dynamic shared memory is one
// static buffer. Launches go through GF_LAUNCH (csrc/common.cuh), which this
// header defines first. Used by tests/test_torch_kernels_emulated.py with
//   g++ -std=c++20 -shared -fPIC -include cuda_runtime.h -I<this dir> -x c++ file.cu
// Warp-level intrinsics are not emulated; the kernels do not use them.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
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
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) alignas(x)

inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }

inline std::barrier<>* gf_emu_barrier = nullptr;
inline void __syncthreads() { gf_emu_barrier->arrive_and_wait(); }

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
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            body();
          });
        for (auto& th : threads) th.join();
      }
}

#define GF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  gf_emu_launch(dim3(grid), dim3(block), [&] { kernel(__VA_ARGS__); })
