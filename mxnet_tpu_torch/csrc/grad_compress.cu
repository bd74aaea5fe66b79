// Q1: 2-bit gradient quantization with error feedback, the function of
// the JAX package's host numpy quantize_2bit (mxnet_tpu/compression.py):
// work = g + r in float32 (g alone on the first push, r null), an element
// fires +t where work >= t and -t where work <= -t (both masks taken
// before either subtraction; NaN fires nowhere and stays in the
// residual), the residual becomes work - t, work + t or work, and the
// codes (1 positive, 2 negative, 0 else) pack four to a byte, element
// 4j+i at bits 2i of byte j, the padding codes 0.
//
// It replaces no TPU kernel: the JAX package's worker reads the whole
// reduced gradient back to the host and quantizes it with numpy. Here the
// gradient and its residual stay on the card and only the codes, a
// sixteenth of the fp32 bytes, are copied to the host.
//
// Bound: bytes (read g and r, write r, a quarter byte of code: 12.25
// bytes a value; 8.25 without r). Design: a grid-stride loop in which a
// thread takes 16 values by four 16-byte loads of g and of r, writes four
// 16-byte stores of the residual and one 32-bit store of codes (value e of
// the 16 at bits 2e, little-endian, which is the byte packing); then a
// loop over the code bytes left (the tail of n % 16 values, or every byte
// when a pointer is off its 16-byte alignment, as a stripe of a (rows,
// cols) tensor may be). r may be null and may alias the residual output
// (in place: each value is read before it is written, by the same
// thread). __fadd_rn / __fsub_rn keep nvcc from contracting; no fast math,
// so subnormals are not flushed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ unsigned quantize(float w, float t, float* res) {
  const bool pos = w >= t;
  const bool neg = w <= -t;
  *res = pos ? __fsub_rn(w, t) : (neg ? __fadd_rn(w, t) : w);
  return pos ? 1u : (neg ? 2u : 0u);
}

template <bool HAS_R>
__global__ void __launch_bounds__(NT)
    quantize_2bit_kernel(const float* __restrict__ g, const float* r,
                         float* r_out, unsigned char* __restrict__ codes,
                         long long n, long long nv, float t) {
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = first; i < nv; i += stride) {
    const float4* gv = reinterpret_cast<const float4*>(g) + 4 * i;
    float4 w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = __ldg(gv + q);
    if (HAS_R) {
      const float4* rv = reinterpret_cast<const float4*>(r) + 4 * i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 rq = rv[q];
        w[q].x = __fadd_rn(w[q].x, rq.x);
        w[q].y = __fadd_rn(w[q].y, rq.y);
        w[q].z = __fadd_rn(w[q].z, rq.z);
        w[q].w = __fadd_rn(w[q].w, rq.w);
      }
    }
    unsigned word = 0;
    float4* ov = reinterpret_cast<float4*>(r_out) + 4 * i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 o;
      word |= quantize(w[q].x, t, &o.x) << (8 * q);
      word |= quantize(w[q].y, t, &o.y) << (8 * q + 2);
      word |= quantize(w[q].z, t, &o.z) << (8 * q + 4);
      word |= quantize(w[q].w, t, &o.w) << (8 * q + 6);
      ov[q] = o;
    }
    reinterpret_cast<unsigned*>(codes)[i] = word;
  }
  const long long nbytes = (n + 3) / 4;
  for (long long b = nv * 4 + first; b < nbytes; b += stride) {
    unsigned byte = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long k = 4 * b + e;
      if (k < n) {
        const float w = HAS_R ? __fadd_rn(g[k], r[k]) : g[k];
        float o;
        byte |= quantize(w, t, &o) << (2 * e);
        r_out[k] = o;
      }
    }
    codes[b] = (unsigned char)byte;
  }
}

template <bool HAS_R>
int launch(const float* g, const float* r, float* r_out,
           unsigned char* codes, long long n, float t, int sms,
           cudaStream_t st) {
  const bool aligned = (((uintptr_t)g | (uintptr_t)r | (uintptr_t)r_out) &
                        15) == 0 && ((uintptr_t)codes & 3) == 0;
  const long long nv = aligned ? n / 16 : 0;
  const long long items = nv > 0 ? nv : (n + 3) / 4;
  long long blocks = (items + NT - 1) / NT;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  quantize_2bit_kernel<HAS_R><<<(unsigned)blocks, NT, 0, st>>>(
      g, r, r_out, codes, n, nv, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g: n float32 values on the card; r: null or n float32 values (may be
// r_out); r_out: n float32 values; codes: ceil(n / 4) bytes. Returns the
// cudaError_t of the launch.
int mxtt_quantize_2bit(const void* g, const void* r, void* r_out,
                       void* codes, long long n, float t, int device,
                       void* stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* gf = static_cast<const float*>(g);
  const float* rf = static_cast<const float*>(r);
  float* of = static_cast<float*>(r_out);
  unsigned char* cb = static_cast<unsigned char*>(codes);
  if (rf != nullptr) return launch<true>(gf, rf, of, cb, n, t, sms, st);
  return launch<false>(gf, rf, of, cb, n, t, sms, st);
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
