// bfloat16 for tools/cuda_emu: storage (one value, or a pair) and the
// conversions the kernels use, rounding to nearest even as the card does.

#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};
struct alignas(4) __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}

inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) { return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)}; }
