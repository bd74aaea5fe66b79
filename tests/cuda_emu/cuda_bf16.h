// Enough of cuda_bf16.h for the kernels to compile under the emulation:
// the bf16 <-> float conversions (round to nearest even, as the card and
// PyTorch round) run; the tensor-core kernels only compile.
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN: keep it quiet
    return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
