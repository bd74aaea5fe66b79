// o = 2 * x, elementwise: the user kernel of the JAX package's
// tests/test_contrib.py:100-117 (``doubler``, a Pallas kernel launched
// through mx.rtc.PallasKernel), written as CUDA source.  It is not built
// by cuda_lib.build_all: it is compiled at runtime through
// mxnet_tpu_torch.rtc.CudaModule, as a user's kernel would be
// (chip_smoke.py's ``rtc`` phase, tests/test_torch_rtc.py).
extern "C" __global__ void doubler(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}
