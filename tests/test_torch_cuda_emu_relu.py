"""R1, the relu gradient kernel (``csrc/relu_grad.cu``
``relu_grad_kernel``), run on the CPU under the emulation of the CUDA
runtime in ``tests/cuda_emu/``, against its plain version
(``ops/elemwise.py`` ``relu_grad_plain``) bit for bit, and so against
``jax.nn.relu``'s gradient: g where the relu's output is > 0, +0
elsewhere (at +-0, negatives and NaN, whatever g holds there), in the
four dtypes it takes; lengths that leave a tail after the 16-byte
vectors; tensors off their 16-byte alignment (the scalar loop alone);
grids of fewer blocks than vectors (the grid-stride loop).  The output
starts as 0xAB bytes, so a value no thread writes shows.  What it
cannot: what nvcc makes of the source, or speed (``chip_smoke.py``).
Skips without a host C++ compiler."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emu.build import build
from mxnet_tpu_torch.ops import elemwise
import torch_threads  # noqa: F401,E402  a worker's share of the cores

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}
SPECIAL = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30, -1e-30,
           1.5, -2.5, 6e-8, 65504.0]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("relu_grad.cu", str(tmp_path_factory.mktemp("emu_relu")),
                launches=1, extern_shared=0)
    lib.mxtt_relu_grad.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def _inputs(n, dtype, seed):
    rng = np.random.RandomState(seed)
    x = np.where(rng.rand(n) < 0.3, rng.choice(SPECIAL, n),
                 rng.randn(n) * 3)
    x[:len(SPECIAL)] = SPECIAL[:n]
    g = np.where(rng.rand(n) < 0.1, rng.choice(SPECIAL, n),
                 rng.randn(n) * 2)
    y = torch.relu(torch.from_numpy(x).to(dtype))
    # the NaN next to +inf (its bits one above inf's)
    inf = _bits(torch.tensor(float("inf"), dtype=dtype))
    _bits(y)[rng.randint(0, n, 5)] = inf + 1
    return torch.from_numpy(g).to(dtype), y


def _kernel(lib, g, y, skip, sms=132):
    """R1 on g and y placed ``skip`` elements past a 16-byte boundary."""
    n = g.numel()
    size = g.element_size()

    def placed(t):
        buf = torch.zeros(n + skip, dtype=t.dtype)
        buf[skip:] = t
        return buf
    gb, yb = placed(g), placed(y)
    out = torch.full(((n + skip) * size,), 0xAB, dtype=torch.uint8)
    old = ctypes.c_int.in_dll(lib, "emu_sm_count").value
    ctypes.c_int.in_dll(lib, "emu_sm_count").value = sms
    try:
        err = lib.mxtt_relu_grad(gb.data_ptr() + skip * size,
                                 yb.data_ptr() + skip * size,
                                 out.data_ptr() + skip * size, n,
                                 DTYPES[g.dtype], 0, None)
    finally:
        ctypes.c_int.in_dll(lib, "emu_sm_count").value = old
    assert err == 0
    return out[skip * size:].view(g.dtype)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype", list(DTYPES), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("n,skip,sms", [(4099, 0, 132), (37, 0, 132),
                                        (1000, 1, 132), (9000, 0, 1)],
                         ids=["tail", "short", "misaligned", "one_sm"])
def test_relu_grad_kernel_equals_plain_version_bit_for_bit(lib, dtype, n,
                                                           skip, sms):
    g, y = _inputs(n, dtype, seed=n + skip)
    want = elemwise.relu_grad_plain(g, y)
    got = _kernel(lib, g, y, skip, sms)
    assert torch.equal(_bits(got), _bits(want))
    # +0 wherever the output is not > 0, NaN, -0 and negatives included
    keep = y > 0
    assert (_bits(got[~keep]) == 0).all()
    assert torch.equal(_bits(got[keep]), _bits(g[keep]))
    assert not keep.all() and keep.any()
