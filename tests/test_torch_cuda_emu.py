"""The float32 flash-attention backward kernels (``csrc/flash_bwd.cu``, K2
and K3) run on the CPU under an emulation of the CUDA runtime.

The host C++ compiler builds the CUDA source against the headers in
``tests/cuda_emu/`` (``cuda_emu/build.py``): one fiber per CUDA thread
(all on one OS thread, run in shuffled orders between barriers), the
blocks of a grid one after another, a barrier per block for
``__syncthreads``, shared memory as a global array.  ``cp.async`` copies
either land at once (``emu_defer`` 0: a copy started before the
tile's last readers are done shows) or are held in their commit group
until the ``cp.async.wait`` that must cover them (``emu_defer`` 1: a
read before its wait sees stale data).  The kernels' outputs start as
NaN, so an element no thread writes shows too.

What it checks: the kernels' indexing, masks (causal, ragged Sq and Sk,
GQA), pipeline waits and barriers, against the port's plain backward
(``_flash_bwd_reference``, itself held against the JAX package's Pallas
backward in ``test_torch_attention_bwd.py``) within 1e-5 (both sum in
f32 in other orders; measured about 5e-6 at these shapes), and that a
relaunch gives the same bits.  What it cannot: what nvcc makes of the
source, the card's arithmetic, races the host's memory model hides, or
speed (``chip_smoke.py`` runs the kernels on the card).  Skips without a
host C++ compiler."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emu.build import build
from mxnet_tpu_torch.ops import attention as att
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = 1e-5

# B, H, Hk, Sq, Sk, D, causal: both sides of the 64-row tile edges, GQA
# and MQA, Sq != Sk both ways under causal, one row, D 32 / 64 / 128
CASES = [
    (1, 2, 2, 48, 48, 32, False),
    (1, 4, 2, 37, 37, 64, True),
    (1, 4, 1, 130, 130, 32, True),
    (1, 2, 2, 100, 300, 64, True),
    (1, 2, 2, 300, 100, 64, True),
    (1, 2, 1, 1, 1, 64, True),
    (1, 2, 2, 77, 130, 64, False),
    (1, 2, 1, 130, 77, 128, True),
    (1, 2, 2, 80, 80, 64, True),
    (1, 2, 1, 80, 144, 128, False),
    (2, 2, 2, 33, 97, 32, True),
    (1, 2, 2, 96, 96, 64, True),
]
IDS = ["B{}H{}Hk{}Sq{}Sk{}D{}{}".format(*c[:6], "c" if c[6] else "")
       for c in CASES]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("flash_bwd.cu", str(tmp_path_factory.mktemp("cuda_emu")),
                launches=4, extern_shared=4)
    tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.mxtt_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
    lib.mxtt_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    return lib


def _run(lib, q, k, v, g, lse, delta, causal, scale):
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    dq = torch.full_like(q, float("nan"))
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    args = (B, H, Hk, Sq, Sk, D, 0, int(causal), scale, 0, None)
    ins = [t.data_ptr() for t in (q, k, v, g, lse, delta)]
    assert lib.mxtt_flash_bwd_dq(*ins, dq.data_ptr(), *args) == 0
    assert lib.mxtt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                  *args) == 0
    return dq, dk, dv


@pytest.mark.parametrize("defer", [0, 1], ids=["copies_at_start",
                                               "copies_at_wait"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_f32_backward_kernels_match_plain_version(lib, case, defer):
    B, H, Hk, Sq, Sk, D, causal = case
    rng = np.random.default_rng(CASES.index(case))

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    q, k, v, g = mk(B, H, Sq, D), mk(B, Hk, Sk, D), mk(B, Hk, Sk, D), \
        mk(B, H, Sq, D)
    out, lse = att._attn_reference(q, k, v, causal, None, return_lse=True)
    delta = (g * out).sum(-1)
    ctypes.c_int.in_dll(lib, "emu_defer").value = defer
    got = _run(lib, q, k, v, g, lse, delta, causal, D ** -0.5)
    again = _run(lib, q, k, v, g, lse, delta, causal, D ** -0.5)
    ref = att._flash_bwd_reference(q, k, v, out, lse, g, causal, None)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, ref):
        torch.testing.assert_close(a, c, rtol=TOL, atol=TOL, msg=name)
        assert torch.equal(a, b), f"{name}: a relaunch differs"
