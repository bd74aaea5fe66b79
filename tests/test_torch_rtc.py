"""``mxnet_tpu_torch.rtc``: user CUDA kernels on NDArrays, the port of
``mxnet_tpu/rtc.py``.

On the CPU: the op wrapper (``CudaFunction``, the counterpart of the
JAX package's ``PallasKernel``) with a plain ``fn``, held against the
JAX ``PallasKernel`` running the Pallas doubler of
``tests/test_contrib.py:100`` in interpret mode (exact: one
multiplication by 2); the signature parser; ``CudaModule`` and
``CudaKernel.launch`` refusing to run without CUDA.  On the card (marked
``cuda``, skipped here): the doubler written as CUDA source, compiled
through ``CudaModule`` and launched, bit for bit against ``x * 2``.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc

CPU = mt.cpu()

# the doubler as CUDA source, as chip_smoke.py's rtc phase compiles it
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "mxnet_tpu_torch", "csrc", "rtc_doubler.cu")) as _f:
    DOUBLER = _f.read()


def _jax_doubler():
    import jax

    def doubler(x):
        from jax.experimental import pallas as pl

        def kernel(x_ref, o_ref):
            o_ref[...] = x_ref[...] * 2.0

        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=jax.default_backend() != 'tpu')(x)
    return mx.rtc.PallasKernel(doubler)


def test_cuda_function_matches_jax_pallas_kernel():
    a = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    want = _jax_doubler()(mx.nd.array(a)).asnumpy()
    k = rtc.CudaFunction(lambda x: x * 2, name="doubler")
    got = k(mt.nd.array(a, ctx=CPU))
    assert got.context == CPU
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(got.asnumpy(), 2 * a)


def test_cuda_function_records_and_passes_attrs():
    x = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    x.attach_grad()
    k = rtc.CudaFunction(lambda t, scale=1.0: t * scale)
    with mt.autograd.record():
        y = k(x, scale=3.0)
    y.backward()
    np.testing.assert_array_equal(y.asnumpy(), 3 * x.asnumpy())
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full((2, 3), 3.0))
    with pytest.raises(mt.MXNetError):
        rtc.CudaFunction("not callable")


def test_signature_parser():
    assert rtc.parse_signature("const float* x, float *y, int n") == [
        (True, np.dtype(np.float32), True),
        (False, np.dtype(np.float32), True),
        (False, np.dtype(np.int32), False)]
    assert rtc.parse_signature("double a,int64_t*b , __half h") == [
        (False, np.dtype(np.float64), False),
        (False, np.dtype(np.int64), True),
        (False, np.dtype(np.float16), False)]
    with pytest.raises(ValueError):
        rtc.parse_signature("const * x")
    with pytest.raises(ValueError):
        rtc.parse_signature("float** x")
    with pytest.raises(TypeError):
        rtc.parse_signature("bfloat16* x")


def test_cuda_module_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        rtc.CudaModule(DOUBLER)


def test_launch_refuses_a_cpu_context():
    """A kernel never runs a plain version: a CPU context or a CPU array
    raises before anything is launched."""
    k = rtc.CudaKernel(None, "doubler", rtc.parse_signature(
        "const float* x, float* y, int n"), path=None)
    x = mt.nd.zeros((4,), ctx=CPU)
    with pytest.raises(mt.MXNetError, match="GPU context"):
        k.launch([x, x, 4], CPU, (1,), (4,))
    assert k.launches == 0


@pytest.mark.cuda
def test_doubler_compiles_and_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    mod = rtc.CudaModule(DOUBLER)
    k = mod.get_kernel("doubler", "const float* x, float* y, int n")
    x = mt.nd.array(np.random.RandomState(0).randn(1000).astype(np.float32),
                    ctx=mt.gpu(0))
    y = mt.nd.zeros((1000,), ctx=mt.gpu(0))
    k.launch([x, y, 1000], mt.gpu(0), (4,), (256,))
    assert k.launches == 1
    np.testing.assert_array_equal(y.asnumpy(), 2 * x.asnumpy())
    with pytest.raises(mt.MXNetError):
        k.launch([x, y], mt.gpu(0), (4,), (256,))
