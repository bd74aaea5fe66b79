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
// Crop offsets are clamped as io_native.cc:285-289 clamps them, high
// first. A null pointer is a failed decode: its pixels are 0, as the host
// zero-fills. Every float operation is IEEE single precision with no
// contraction into fused multiply-adds (the __f*_rn intrinsics), in the
// host code's order (tap, two horizontal lerps, the vertical lerp,
// + 0.5f, truncate, then (v - mean) * inv_std), so the result equals the
// plain version (mxnet_tpu_torch/ops/image_augment.py augment_plain) and
// the host code bit for bit on the same pixels.
//
// Bound: bytes. It reads the decoded pixels its crop window reaches and
// writes the batch once (the main path: about 110 MB read and 154 MB
// written at batch 256, 3 x 224 x 224 float32), against 2 to 8 bilinear
// taps of arithmetic a value. The first design (one thread a pixel) spent
// about 300 instructions a pixel (64-bit divisions for (n, y, x), both
// axes' taps with an IEEE division, 15 integer <-> float conversions at a
// sixteenth of the FMA rate, 12 byte loads from device memory) and ran at
// 2.4-5x the bound. This one:
//   - a block per (band of R output rows, image): the image comes from
//     blockIdx.y, its table is read once a thread, and no thread divides
//     to find its pixel;
//   - the taps once: the column taps (byte offsets of both taps and the
//     weight, the mirror applied) once a block into shared memory, the
//     row taps once an output row, by the same tap() arithmetic;
//   - the band's source window (the rows its row taps reach, the columns
//     [first tap, last tap] of the crop) staged into shared memory with
//     16-byte loads, each row's start aligned down and its byte offset
//     carried, so the taps are gathered from shared memory, not through
//     L1 (a warp's byte gathers span some 750 bytes of a row);
//   - four adjacent output x a thread: one float4 store a channel plane
//     (float32 NCHW), one 32-bit store a plane (uint8 NCHW), c 32-bit
//     words (uint8 NHWC); a ragged width or a misaligned output takes
//     scalar stores;
//   - bytes to floats and back without the slow conversion unit:
//     2^23 + b is the float whose low mantissa bits are b, so
//     (2^23 | b) - 2^23 is (float)b exactly, and 2^23 + t rounded toward
//     zero holds (int)t in its low byte for 0 <= t < 2^23;
//   - the identity (raw records: 256 x 256 stored, cropped to 224) skips
//     the taps: a staged crop-and-mirror copy.
// A window larger than the staging buffer (a downscale of more than about
// 2.2x at this crop) reads its taps from device memory instead, with the
// same arithmetic.
//
// A row's 16-byte loads may reach up to 15 bytes before or after the
// image's bytes; each such load lies in an aligned 16-byte unit that holds
// at least one byte of the image, so it never leaves the pages of the
// buffer, and those bytes are never used.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;             // threads a block
constexpr int R = 8;                // output rows a block (a band)
constexpr int MAX_C = 4;
constexpr int STAGE_BYTES = 24576;  // shared memory for the staged rows
constexpr float TWO23 = 8388608.f;

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

// a byte as 2^23 + b (the form every value takes until it is stored)
__device__ __forceinline__ float biased(unsigned b) {
  return __uint_as_float(0x4B000000u | b);
}

// (float)b, exactly
__device__ __forceinline__ float u8f(unsigned b) {
  return __fsub_rn(biased(b), TWO23);
}

// The dynamic shared memory of a block: the column taps of the ow output
// columns padded to a multiple of 4 (byte offsets of both taps in a
// staged row, the weight), the row taps of the band (staged row indices,
// the weight), then the staged rows.
struct Layout {
  int cols, stage, bytes;
  __host__ __device__ explicit Layout(int ow) {
    cols = (ow + 3) & ~3;
    stage = (3 * cols + 3 * R) * 4;
    stage = (stage + 15) & ~15;
    bytes = stage + STAGE_BYTES;
  }
};

// what a band of one image computes
struct Band {
  const unsigned char* img;  // the image (HWC), or null: a failed decode
  int w;                     // its width
  int y, rows;               // first output row, rows in this band
  int rlo, clo;              // the source window's first row and column
  int pitch;                 // bytes a staged row
  int* cx0;
  int* cx1;
  float* wx;  // column taps
  int* ry0;
  int* ry1;
  float* wy;  // row taps
  unsigned char* stage;
};

// image row rlo + s, from its first tapped column: staged or in place
template <int C, bool STAGED>
__device__ __forceinline__ const unsigned char* source_row(const Band& b,
                                                           int s) {
  const unsigned char* p = b.img + ((size_t)(b.rlo + s) * b.w + b.clo) * C;
  if (!STAGED) return p;
  return b.stage + s * b.pitch + (int)((uintptr_t)p & 15);
}

// Store the quad of 2^23-biased uint8 values v (pixels x .. x + 3 of
// output row y of image i, channels 0 .. C - 1); vec: 16-byte aligned
// rows of a width that is a multiple of 4.
template <int C>
__device__ __forceinline__ void store(float* out, const float (&v)[4][C],
                                      const float (&mean)[C],
                                      const float (&inv)[C], int i, int y,
                                      int x, int oh, int ow, bool vec) {
  const long long plane = (long long)oh * ow;
  float* o = out + (long long)i * C * plane + (long long)y * ow + x;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __fmul_rn(__fsub_rn(__fsub_rn(v[j][k], TWO23), mean[k]),
                       inv[k]);
    if (vec) {
      *reinterpret_cast<float4*>(o + k * plane) =
          make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < ow) o[k * plane + j] = f[j];
    }
  }
}

__device__ __forceinline__ unsigned low_byte(float v) {
  return __float_as_uint(v) & 0xFFu;
}

template <int C, bool NHWC>
__device__ __forceinline__ void store_u8(unsigned char* out,
                                        const float (&v)[4][C], int i,
                                        int y, int x, int oh, int ow,
                                        bool vec) {
  if (NHWC) {
    unsigned char* o = out + (((long long)i * oh + y) * ow + x) * C;
    if (vec) {
      // the quad's 4 * C bytes as C words
#pragma unroll
      for (int q = 0; q < C; ++q) {
        unsigned word = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          word |= low_byte(v[(4 * q + t) / C][(4 * q + t) % C]) << (8 * t);
        reinterpret_cast<unsigned*>(o)[q] = word;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < ow) {
#pragma unroll
          for (int k = 0; k < C; ++k)
            o[j * C + k] = (unsigned char)low_byte(v[j][k]);
        }
    }
    return;
  }
  const long long plane = (long long)oh * ow;
  unsigned char* o = out + (long long)i * C * plane + (long long)y * ow + x;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (vec) {
      *reinterpret_cast<unsigned*>(o + k * plane) =
          low_byte(v[0][k]) | low_byte(v[1][k]) << 8 |
          low_byte(v[2][k]) << 16 | low_byte(v[3][k]) << 24;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < ow) o[k * plane + j] = (unsigned char)low_byte(v[j][k]);
    }
  }
}

enum Mode { ZERO, IDENTITY, RESIZE };

// every quad of the band: MODE says where the values come from, STAGED
// whether the source rows are in shared memory
template <int C, int MODE, bool STAGED, typename OutT, bool NHWC>
__device__ __forceinline__ void quads(const Band& b, OutT* out,
                                      const float (&mean)[C],
                                      const float (&inv)[C], int i, int oh,
                                      int ow, bool vec) {
  const int nq = (ow + 3) >> 2;
  for (int it = threadIdx.x; it < b.rows * nq; it += NT) {
    const int r = it / nq;
    const int x = 4 * (it - r * nq);
    float v[4][C];
    if (MODE == ZERO) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < C; ++k) v[j][k] = TWO23;
    } else if (MODE == IDENTITY) {
      const unsigned char* p = source_row<C, STAGED>(b, b.ry0[r]);
      const int4 cx = *reinterpret_cast<const int4*>(b.cx0 + x);
      const int c4[4] = {cx.x, cx.y, cx.z, cx.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < C; ++k) v[j][k] = biased(p[c4[j] + k]);
    } else {
      const unsigned char* p0 = source_row<C, STAGED>(b, b.ry0[r]);
      const unsigned char* p1 = source_row<C, STAGED>(b, b.ry1[r]);
      const float wy = b.wy[r];
      const int4 a = *reinterpret_cast<const int4*>(b.cx0 + x);
      const int4 e = *reinterpret_cast<const int4*>(b.cx1 + x);
      const float4 wx = *reinterpret_cast<const float4*>(b.wx + x);
      const int a4[4] = {a.x, a.y, a.z, a.w};
      const int e4[4] = {e.x, e.y, e.z, e.w};
      const float w4[4] = {wx.x, wx.y, wx.z, wx.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float v0 =
              lerp(u8f(p0[a4[j] + k]), u8f(p0[e4[j] + k]), w4[j]);
          const float v1 =
              lerp(u8f(p1[a4[j] + k]), u8f(p1[e4[j] + k]), w4[j]);
          // + 0.5f, then 2^23 + the truncated value (rounding toward
          // zero at a unit step)
          v[j][k] = __fadd_rz(__fadd_rn(lerp(v0, v1, wy), 0.5f), TWO23);
        }
    }
    if (sizeof(OutT) == 4)
      store<C>(reinterpret_cast<float*>(out), v, mean, inv, i, b.y + r, x,
               oh, ow, vec);
    else
      store_u8<C, NHWC>(reinterpret_cast<unsigned char*>(out), v, i,
                        b.y + r, x, oh, ow, vec);
  }
}

template <int C, typename OutT, bool NHWC>
__device__ __forceinline__ void band(const long long* __restrict__ meta,
                                     OutT* __restrict__ out, int n, int dh,
                                     int dw, int oh, int ow, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i = blockIdx.y;
  const Layout lay(ow);
  Band b;
  b.img = reinterpret_cast<const unsigned char*>(__ldg(meta + i));
  const int h = (int)__ldg(meta + n + i);
  b.w = (int)__ldg(meta + 2 * n + i);
  int y0 = (int)__ldg(meta + 3 * n + i);
  int x0 = (int)__ldg(meta + 4 * n + i);
  const bool flip = __ldg(meta + 5 * n + i) != 0;
  if (y0 > dh - oh) y0 = dh - oh;
  if (x0 > dw - ow) x0 = dw - ow;
  if (y0 < 0) y0 = 0;
  if (x0 < 0) x0 = 0;
  b.y = blockIdx.x * R;
  b.rows = oh - b.y < R ? oh - b.y : R;
  b.cx0 = reinterpret_cast<int*>(smem_raw);
  b.cx1 = b.cx0 + lay.cols;
  b.wx = reinterpret_cast<float*>(b.cx1 + lay.cols);
  b.ry0 = reinterpret_cast<int*>(b.wx + lay.cols);
  b.ry1 = b.ry0 + R;
  b.wy = reinterpret_cast<float*>(b.ry1 + R);
  b.stage = smem_raw + lay.stage;
  // the normalization (read by the float output only): mean, then 1 / std
  const float* norm = reinterpret_cast<const float*>(meta + 6 * n);
  float mean[C], inv[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    mean[k] = __ldg(norm + k);
    inv[k] = __ldg(norm + MAX_C + k);
  }
  if (b.img == nullptr) {
    quads<C, ZERO, false, OutT, NHWC>(b, out, mean, inv, i, oh, ow, vec);
    return;
  }
  const bool ident = h == dh && b.w == dw;
  // the source window: rows rlo .. rhi, columns clo .. chi (the taps are
  // monotone in the output coordinate, the mirror only reorders them)
  int rhi, chi;
  if (ident) {
    b.rlo = y0 + b.y;
    rhi = b.rlo + b.rows - 1;
    b.clo = x0;
    chi = x0 + ow - 1;
  } else {
    b.rlo = tap(y0 + b.y, h, dh).i0;
    rhi = tap(y0 + b.y + b.rows - 1, h, dh).i1;
    b.clo = tap(x0, b.w, dw).i0;
    chi = tap(x0 + ow - 1, b.w, dw).i1;
  }
  const int span = (chi - b.clo + 1) * C;
  const int nrows = rhi - b.rlo + 1;
  b.pitch = (span + 30) & ~15;  // room for a row's offset of up to 15
  const bool staged = nrows * b.pitch <= STAGE_BYTES;
  for (int x = threadIdx.x; x < lay.cols; x += NT) {
    const int xo = x < ow ? x : ow - 1;  // the padding repeats the last
    const int rx = x0 + (flip ? ow - 1 - xo : xo);
    if (ident) {
      b.cx0[x] = (rx - b.clo) * C;
    } else {
      const Tap t = tap(rx, b.w, dw);
      b.cx0[x] = (t.i0 - b.clo) * C;
      b.cx1[x] = (t.i1 - b.clo) * C;
      b.wx[x] = t.w;
    }
  }
  if (threadIdx.x < b.rows) {
    const int ry = y0 + b.y + threadIdx.x;
    if (ident) {
      b.ry0[threadIdx.x] = ry - b.rlo;
    } else {
      const Tap t = tap(ry, h, dh);
      b.ry0[threadIdx.x] = t.i0 - b.rlo;
      b.ry1[threadIdx.x] = t.i1 - b.rlo;
      b.wy[threadIdx.x] = t.w;
    }
  }
  if (staged) {
    // a warp a source row, four 16-byte loads a lane in flight
    const int lane = threadIdx.x & 31;
    for (int s = threadIdx.x >> 5; s < nrows; s += NT / 32) {
      const unsigned char* p =
          b.img + ((size_t)(b.rlo + s) * b.w + b.clo) * C;
      const int off = (int)((uintptr_t)p & 15);
      const uint4* src = reinterpret_cast<const uint4*>(p - off);
      uint4* dst = reinterpret_cast<uint4*>(b.stage + s * b.pitch);
      const int nch = (off + span + 15) >> 4;
      for (int c0 = 0; c0 < nch; c0 += 4 * 32) {
        uint4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + 32 * j + lane < nch) v[j] = __ldg(src + c0 + 32 * j + lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + 32 * j + lane < nch) dst[c0 + 32 * j + lane] = v[j];
      }
    }
  }
  __syncthreads();
  if (ident && staged)
    quads<C, IDENTITY, true, OutT, NHWC>(b, out, mean, inv, i, oh, ow, vec);
  else if (ident)
    quads<C, IDENTITY, false, OutT, NHWC>(b, out, mean, inv, i, oh, ow, vec);
  else if (staged)
    quads<C, RESIZE, true, OutT, NHWC>(b, out, mean, inv, i, oh, ow, vec);
  else
    quads<C, RESIZE, false, OutT, NHWC>(b, out, mean, inv, i, oh, ow, vec);
}

template <typename OutT, bool NHWC>
__global__ void __launch_bounds__(NT, 8)
    image_augment_kernel(const long long* __restrict__ meta,
                         OutT* __restrict__ out, int n, int c, int dh, int dw,
                         int oh, int ow, int vec) {
  switch (c) {
    case 1:
      band<1, OutT, NHWC>(meta, out, n, dh, dw, oh, ow, vec != 0);
      break;
    case 2:
      band<2, OutT, NHWC>(meta, out, n, dh, dw, oh, ow, vec != 0);
      break;
    case 3:
      band<3, OutT, NHWC>(meta, out, n, dh, dw, oh, ow, vec != 0);
      break;
    default:
      band<4, OutT, NHWC>(meta, out, n, dh, dw, oh, ow, vec != 0);
  }
}

template <typename OutT, bool NHWC>
int launch(const long long* meta, void* out, int n, int c, int dh, int dw,
           int oh, int ow, int smem, int vec, cudaStream_t st) {
  auto* kernel = image_augment_kernel<OutT, NHWC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((oh + R - 1) / R), (unsigned)n);
  image_augment_kernel<OutT, NHWC><<<grid, NT, smem, st>>>(
      meta, static_cast<OutT*>(out), n, c, dh, dw, oh, ow, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// meta: int64 (6 * n + 4) on the card: rows pointer, h, w, y0, x0, flip
// of each image (pointer 0 for a failed decode), then 8 float32: the mean
// and 1 / std of channels 0 .. 3 (read by the float output only); out:
// (n, c, oh, ow) (NCHW) or (n, oh, ow, c) (NHWC). out_kind 0 = float32
// NCHW, 1 = uint8 NCHW, 2 = uint8 NHWC. Returns the cudaError_t of the
// launch.
int mxtt_image_augment(const void* meta, void* out, int n, int c, int dh,
                       int dw, int oh, int ow, int out_kind, int device,
                       void* stream) {
  if (n == 0) return 0;
  if (c < 1 || c > MAX_C || oh < 1 || ow < 1 || oh > dh || ow > dw ||
      n > 65535 || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const int smem = Layout(ow).bytes;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long* m = static_cast<const long long*>(meta);
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t align = out_kind == 0 ? 15 : 3;  // float4 or words
  const int vec = ow % 4 == 0 && ((uintptr_t)out & align) == 0;
  if (out_kind == 0)
    return launch<float, false>(m, out, n, c, dh, dw, oh, ow, smem, vec, st);
  if (out_kind == 1)
    return launch<unsigned char, false>(m, out, n, c, dh, dw, oh, ow, smem,
                                        vec, st);
  return launch<unsigned char, true>(m, out, n, c, dh, dw, oh, ow, smem, vec,
                                     st);
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
