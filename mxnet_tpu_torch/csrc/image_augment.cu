// I1: the fused resize -> crop -> mirror -> normalize pass of the record
// iterators on the card, for a batch of images decoded into card memory
// (csrc/nvjpeg_decode.cu), each at its own size.
//
// It replaces no TPU kernel: the JAX package does this work on the host,
// in C++ (mxnet_tpu/native/io_native.cc jpeg_decode_augment_batch :250,
// with resize_bilinear :127 folded in, and crop_flip_u8_batch :322 /
// crop_flip_u8_nhwc_batch :366 for raw records), because the TPU has no
// JPEG decoder. On the H100 the pixels are already in card memory after
// nvJPEG, so the pass runs where they are, and the batch never crosses
// the PCIe bus.
//
// For every output pixel (n, y, x) and each channel k it
//   - samples image n (a pointer table, each image's own h and w) at the
//     pixel (y0 + y, x0 + x') of the image resized to (dh, dw), with
//     x' = ow - 1 - x when the image is mirrored, by resize_bilinear's
//     formula (identity where h == dh and w == dw, as io_native.cc copies
//     there), rounded to uint8 as that code rounds (+ 0.5f, truncate);
//   - writes (v - mean[k]) * inv_std[k] as float32 NCHW (the fused host
//     path multiplies by 1 / std, which the caller computes in float32),
//     or the uint8 value, NCHW or NHWC (the raw-record iterator).
// Crop offsets are clamped as io_native.cc:285-289 clamps them. A null
// pointer is a failed decode: its pixels are 0, as the host zero-fills.
// Every float operation is IEEE single precision with no contraction
// into fused multiply-adds (the __f*_rn intrinsics), so the result equals
// the plain version (mxnet_tpu_torch/ops/image_augment.py
// augment_plain) and the host code bit for bit on the same pixels.
//
// Bound: bytes. It reads the decoded pixels its crop window reaches and
// writes the batch once (the main path: about 110 MB read and 154 MB
// written at batch 256, 3 x 224 x 224 float32), against 2 to 8 bilinear
// taps of arithmetic a value. Design: one thread a pixel, its channels in
// a loop, so the sampling coordinates and weights are computed once for
// all channels; neighbouring threads take neighbouring x, so each
// channel plane's stores coalesce and the taps of a warp fall in a few
// source rows. The per-image table (pointer, h, w, y0, x0, flip) is read
// through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_C = 4;

struct Tap {
  int i0, i1;
  float w;
};

// resize_bilinear's source taps and weight along one axis, for output
// coordinate r of a resize from `in` to `out` (io_native.cc:131-141)
__device__ __forceinline__ Tap tap(int r, int in, int out) {
  const float s = __fdiv_rn((float)in, (float)out);
  const float f = __fsub_rn(__fmul_rn(__fadd_rn((float)r, 0.5f), s), 0.5f);
  Tap t;
  t.i0 = (int)f;
  if (t.i0 < 0) t.i0 = 0;
  t.i1 = t.i0 + 1 < in ? t.i0 + 1 : in - 1;
  t.w = __fsub_rn(f, (float)t.i0);
  if (t.w < 0.f) t.w = 0.f;
  return t;
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), w));
}

template <typename OutT>
struct Store;

template <>
struct Store<float> {
  static __device__ __forceinline__ float of(unsigned char v, float m,
                                             float is) {
    return __fmul_rn(__fsub_rn((float)v, m), is);
  }
};

template <>
struct Store<unsigned char> {
  static __device__ __forceinline__ unsigned char of(unsigned char v, float,
                                                     float) {
    return v;
  }
};

template <typename OutT, bool NHWC>
__global__ void __launch_bounds__(NT)
    image_augment_kernel(const long long* __restrict__ meta,
                         const float* __restrict__ norm,
                         OutT* __restrict__ out, int n, int c, int dh, int dw,
                         int oh, int ow) {
  const long long pix = (long long)blockIdx.x * NT + threadIdx.x;
  const long long plane = (long long)oh * ow;
  if (pix >= (long long)n * plane) return;
  const int i = (int)(pix / plane);
  const int y = (int)((pix - (long long)i * plane) / ow);
  const int x = (int)(pix - (long long)i * plane - (long long)y * ow);
  const unsigned char* img =
      reinterpret_cast<const unsigned char*>(__ldg(meta + i));
  const int h = (int)__ldg(meta + n + i);
  const int w = (int)__ldg(meta + 2 * n + i);
  int y0 = (int)__ldg(meta + 3 * n + i);
  int x0 = (int)__ldg(meta + 4 * n + i);
  const bool flip = __ldg(meta + 5 * n + i) != 0;
  if (y0 > dh - oh) y0 = dh - oh;
  if (x0 > dw - ow) x0 = dw - ow;
  if (y0 < 0) y0 = 0;
  if (x0 < 0) x0 = 0;
  const int ry = y0 + y;
  const int rx = x0 + (flip ? ow - 1 - x : x);
  // the channels in unrolled loops over MAX_C, guarded by c, so that v
  // stays in registers
  unsigned char v[MAX_C];
  if (img == nullptr) {
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) v[k] = 0;
  } else if (h == dh && w == dw) {
    const unsigned char* p = img + ((size_t)ry * w + rx) * c;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) v[k] = p[k];
  } else {
    const Tap ty = tap(ry, h, dh), tx = tap(rx, w, dw);
    const unsigned char* r0 = img + (size_t)ty.i0 * w * c;
    const unsigned char* r1 = img + (size_t)ty.i1 * w * c;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) {
      if (k >= c) break;
      const float v0 = lerp((float)r0[tx.i0 * c + k],
                            (float)r0[tx.i1 * c + k], tx.w);
      const float v1 = lerp((float)r1[tx.i0 * c + k],
                            (float)r1[tx.i1 * c + k], tx.w);
      v[k] = (unsigned char)(int)__fadd_rn(lerp(v0, v1, ty.w), 0.5f);
    }
  }
  if (NHWC) {
    OutT* o = out + pix * c;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) o[k] = Store<OutT>::of(v[k], norm[k], norm[c + k]);
  } else {
    OutT* o = out + (long long)i * c * plane + (long long)y * ow + x;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c)
        o[(long long)k * plane] =
            Store<OutT>::of(v[k], norm[k], norm[c + k]);
  }
}

}  // namespace

extern "C" {

// meta: int64 (6, n) on the card, rows pointer, h, w, y0, x0, flip of each
// image (pointer 0 for a failed decode); norm: float32 (2, c) on the card,
// mean then 1 / std (read by the float output only); out: (n, c, oh, ow)
// (NCHW) or (n, oh, ow, c) (NHWC). out_kind 0 = float32 NCHW, 1 = uint8
// NCHW, 2 = uint8 NHWC. Returns the cudaError_t of the launch.
int mxtt_image_augment(const void* meta, const void* norm, void* out, int n,
                       int c, int dh, int dw, int oh, int ow, int out_kind,
                       int device, void* stream) {
  if (n == 0) return 0;
  if (c < 1 || c > MAX_C || oh < 1 || ow < 1 || oh > dh || ow > dw ||
      out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)n * oh * ow;
  const long long blocks = (pixels + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long* m = static_cast<const long long*>(meta);
  const float* nm = static_cast<const float*>(norm);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)blocks);
  if (out_kind == 0)
    image_augment_kernel<float, false><<<grid, NT, 0, st>>>(
        m, nm, static_cast<float*>(out), n, c, dh, dw, oh, ow);
  else if (out_kind == 1)
    image_augment_kernel<unsigned char, false><<<grid, NT, 0, st>>>(
        m, nm, static_cast<unsigned char*>(out), n, c, dh, dw, oh, ow);
  else
    image_augment_kernel<unsigned char, true><<<grid, NT, 0, st>>>(
        m, nm, static_cast<unsigned char*>(out), n, c, dh, dw, oh, ow);
  return (int)cudaGetLastError();
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
