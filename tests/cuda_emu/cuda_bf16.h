// Enough of cuda_bf16.h for the bf16 kernels to compile under the
// emulation; they are never run there.
#pragma once
struct __nv_bfloat16 { unsigned short bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
