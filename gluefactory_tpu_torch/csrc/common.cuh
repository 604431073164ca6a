// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source is built on its own by nvcc into a shared library
// with a plain C interface (gluefactory_tpu_torch/_ext.py), loaded with
// ctypes. Element type codes passed from Python: 0 = float32, 1 = bfloat16.
// Launches go through GF_LAUNCH and dynamic shared memory through
// GF_DYN_SMEM so that tests/cuda_emu can run these sources on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef GF_LAUNCH
#define GF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

#ifndef GF_DYN_SMEM
#define GF_DYN_SMEM(type, name)                                  \
  extern __shared__ __align__(16) unsigned char gf_smem_raw_[]; \
  type* name = reinterpret_cast<type*>(gf_smem_raw_)
#endif

namespace gf {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr float kNeg = -1e9f;  // finite "minus infinity" of the assignment

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded through T and back: the rounding point of the bf16 path.
template <class T>
__device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once).
template <class K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace gf
