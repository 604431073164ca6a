// Stand-in for cuda_bf16.h on the CPU (see cuda_runtime.h here): bfloat16 as
// the top 16 bits of a float, converted with round-to-nearest-even; bf16x2
// pairs and their arithmetic.
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

// bf16x2 arithmetic: each lane's result correctly rounded once (a bf16 sum
// or product is exact in fp32 before the one rounding to bf16). Only the _rn
// forms: on the card the plain __hmul2 / __hadd2 may be contracted into one
// fma, which rounds once where the kernels' rounding points ask for twice.
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return __nv_bfloat162{__float2bfloat16(a), __float2bfloat16(b)};
}

template <class F>
inline __nv_bfloat162 gf_emu_bf16x2(__nv_bfloat162 a, __nv_bfloat162 b, F op) {
  return __floats2bfloat162_rn(op(__bfloat162float(a.x), __bfloat162float(b.x)),
                               op(__bfloat162float(a.y), __bfloat162float(b.y)));
}
inline __nv_bfloat162 __hadd2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return gf_emu_bf16x2(a, b, [](float u, float v) { return u + v; });
}
inline __nv_bfloat162 __hmul2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return gf_emu_bf16x2(a, b, [](float u, float v) { return u * v; });
}
inline __nv_bfloat162 __hmax2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return gf_emu_bf16x2(a, b, [](float u, float v) { return u > v ? u : v; });
}
