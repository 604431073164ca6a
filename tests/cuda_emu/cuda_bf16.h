// Stand-in for cuda_bf16.h on the CPU (see cuda_runtime.h here): bfloat16 as
// the top 16 bits of a float, converted with round-to-nearest-even.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  __nv_bfloat16 v;
  v.bits = (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
  return v;
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short u) { return __nv_bfloat16{u}; }
