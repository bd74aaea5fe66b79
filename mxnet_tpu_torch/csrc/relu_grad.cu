// R1: the gradient of relu as the JAX package defines it, g where y > 0
// and 0 elsewhere (jax.nn.relu's rule, select(x > 0, g, 0)), for y the
// relu's output, which is > 0 exactly where its input is. It is 0 where
// the input was NaN; torch's own relu backward passes g there.
//
// It replaces no TPU kernel: XLA fuses the JAX package's select into the
// backward it compiles. In eager PyTorch the same rule costs a comparison
// and a where (two passes over the activations, 4.5 ms of a ResNet-50
// training step at batch 256 on the H100); this is one pass.
//
// Bound: bytes (two inputs read and one output written once, one
// comparison a value). Design: a grid-stride loop over 16-byte vectors of
// the three tensors (8 bf16 or fp16, 4 fp32, 2 fp64 values), the test on
// the value's bits (positive, not zero, not NaN: b - 1 < the bits of +inf,
// unsigned), a scalar tail for what is left and for misaligned tensors.
// The result is g's bits or +0, bit for bit the plain version
// (mxnet_tpu_torch/ops/elemwise.py relu_grad_plain).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename U, U INF>
__device__ __forceinline__ U pass(U g, U y) {
  return (U)(y - 1) < INF ? g : (U)0;
}

template <typename U, U INF>
__global__ void __launch_bounds__(NT)
    relu_grad_kernel(const U* __restrict__ g, const U* __restrict__ y,
                     U* __restrict__ out, long long n, long long nv) {
  constexpr int V = 16 / sizeof(U);
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = first; i < nv; i += stride) {
    uint4 gv = __ldg(reinterpret_cast<const uint4*>(g) + i);
    const uint4 yv = __ldg(reinterpret_cast<const uint4*>(y) + i);
    U* gu = reinterpret_cast<U*>(&gv);
    const U* yu = reinterpret_cast<const U*>(&yv);
#pragma unroll
    for (int j = 0; j < V; ++j) gu[j] = pass<U, INF>(gu[j], yu[j]);
    reinterpret_cast<uint4*>(out)[i] = gv;
  }
  for (long long i = nv * V + first; i < n; i += stride)
    out[i] = pass<U, INF>(g[i], y[i]);
}

template <typename U, U INF>
int launch(const void* g, const void* y, void* out, long long n, int sms,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(U);
  const bool aligned = (((uintptr_t)g | (uintptr_t)y | (uintptr_t)out) &
                        15) == 0;
  const long long nv = aligned ? n / V : 0;
  const long long items = nv > 0 ? nv : n;
  long long blocks = (items + NT - 1) / NT;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  relu_grad_kernel<U, INF><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const U*>(g), static_cast<const U*>(y),
      static_cast<U*>(out), n, nv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g, y, out: n contiguous values on the card; dtype 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = float64. Returns the cudaError_t of the
// launch.
int mxtt_relu_grad(const void* g, const void* y, void* out, long long n,
                   int dtype, int device, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<uint32_t, 0x7F800000u>(g, y, out, n, sms, st);
  if (dtype == 1) return launch<uint16_t, 0x7F80u>(g, y, out, n, sms, st);
  if (dtype == 2) return launch<uint16_t, 0x7C00u>(g, y, out, n, sms, st);
  return launch<uint64_t, 0x7FF0000000000000ull>(g, y, out, n, sms, st);
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
