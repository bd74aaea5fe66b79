// o = 2 * x, elementwise: the user kernel of the JAX package's
// tests/test_contrib.py:100-117 (``doubler``, a Pallas kernel launched
// through mx.rtc.PallasKernel), written as CUDA source.  It is not built
// by cuda_lib.build_all: it is compiled at runtime through
// mxnet_tpu_torch.rtc.CudaModule, as a user's kernel would be
// (chip_smoke.py's ``rtc`` phase, tests/test_torch_rtc.py).
//
// ``doubler`` is the first design: one thread an element.
// ``doubler_vec4`` is the one the rtc phase calls: 16-byte loads and
// stores (float4; x and y must be 16-byte aligned, as a tensor's storage
// is), a grid-stride loop that keeps four vectors a thread in flight per
// round, and the n % 4 last elements one a thread.  Doubling is exact, so
// both give x * 2 bit for bit.
extern "C" __global__ void doubler(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
}

extern "C" __global__ void doubler_vec4(const float* __restrict__ x,
                                        float* __restrict__ y, int n) {
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* yv = reinterpret_cast<float4*>(y);
  const int nv = n >> 2;
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int i = g;
  for (; i + 3 * stride < nv; i += 4 * stride) {
    float4 a = xv[i];
    float4 b = xv[i + stride];
    float4 c = xv[i + 2 * stride];
    float4 d = xv[i + 3 * stride];
    yv[i] = twice(a);
    yv[i + stride] = twice(b);
    yv[i + 2 * stride] = twice(c);
    yv[i + 3 * stride] = twice(d);
  }
  for (; i < nv; i += stride) yv[i] = twice(xv[i]);
  if (g < (n & 3)) y[(nv << 2) + g] = x[(nv << 2) + g] * 2.0f;
}
