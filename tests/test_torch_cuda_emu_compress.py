"""Q1, the 2-bit gradient quantizer (``csrc/grad_compress.cu``
``quantize_2bit_kernel``), run on the CPU under the emulation of the
CUDA runtime in ``tests/cuda_emu/``, against its plain version
(``compression.quantize_2bit_plain``) and the JAX package's numpy
``quantize_2bit``, bit for bit in codes and residual: with and without a
residual, in place, a stripe off its 16-byte alignment (the byte loop
alone), every ``n % 16`` (the tail), special values (NaN, +-inf, +-0,
subnormals, +-t exactly) at t 0.5 and 0.1 (not representable in
float32), and grids smaller than the work (the grid-stride loops).  The
codes and the residual start as 0xAB bytes, so a word no thread writes
shows.  What it cannot: what nvcc makes of the source, or speed
(``chip_smoke.py`` ``q1_kernel``).  Skips without a host C++ compiler."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emu.build import build
from mxnet_tpu import compression as jax_compression
from mxnet_tpu_torch import compression
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("grad_compress.cu",
                str(tmp_path_factory.mktemp("emu_compress")),
                launches=1, extern_shared=0)
    lib.mxtt_quantize_2bit.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def _inputs(n, t, seed):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * t * 1.5).astype(np.float32)
    t32 = np.float32(t)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39,
                        t32, -t32, np.nextafter(t32, 0),
                        -np.nextafter(t32, 0)], np.float32)
    k = min(n, special.size)
    g[rng.permutation(n)[:k]] = special[:k]
    r = (rng.randn(n) * t * 0.5).astype(np.float32)
    r[rng.permutation(n)[:min(n, 3)]] = np.array([-0.0, 1e-41, 0.0],
                                                 np.float32)[:min(n, 3)]
    return g, r


def _kernel(lib, g, r, t, skip, sms, in_place):
    """Q1 on g (and r) placed ``skip`` floats past a 16-byte boundary."""
    n = g.size

    def placed(a):
        buf = torch.zeros(n + skip, dtype=torch.float32)
        buf[skip:] = torch.from_numpy(a)
        return buf
    gb = placed(g)
    rb = placed(r) if r is not None else None
    if in_place and rb is not None:
        ob = rb
    else:
        ob = torch.full(((n + skip) * 4,), 0xAB,
                        dtype=torch.uint8).view(torch.float32)
    codes = torch.full(((n + 3) // 4,), 0xAB, dtype=torch.uint8)
    old = ctypes.c_int.in_dll(lib, "emu_sm_count").value
    ctypes.c_int.in_dll(lib, "emu_sm_count").value = sms
    try:
        err = lib.mxtt_quantize_2bit(
            gb.data_ptr() + 4 * skip,
            None if rb is None else rb.data_ptr() + 4 * skip,
            ob.data_ptr() + 4 * skip, codes.data_ptr(), n, float(t), 0,
            None)
    finally:
        ctypes.c_int.in_dll(lib, "emu_sm_count").value = old
    assert err == 0
    return codes.numpy(), ob[skip:].numpy()


CASES = [(16 * 3000 + k, 0, 132) for k in (0, 1, 7, 15)] + [
    (16 * 5 + k, 0, 1) for k in range(16)] + [
    (4099, 1, 132), (4099, 2, 1), (37, 3, 132), (3, 0, 132), (1, 1, 132)]


@pytest.mark.parametrize("t", [0.5, 0.1])
@pytest.mark.parametrize("mode", ["first", "residual", "in_place"])
@pytest.mark.parametrize("n,skip,sms", CASES,
                         ids=[f"n{n}_skip{s}_sms{m}" for n, s, m in CASES])
def test_q1_equals_plain_and_jax_bit_for_bit(lib, n, skip, sms, mode, t):
    g, r = _inputs(n, t, seed=n * 7 + skip)
    res = None if mode == "first" else r
    codes, out = _kernel(lib, g, res, t, skip, sms, mode == "in_place")
    want_c, want_r = compression.quantize_2bit_plain(
        torch.from_numpy(g), None if res is None else torch.from_numpy(res),
        t)
    payload, jax_r = jax_compression.quantize_2bit(g, res, t)
    assert np.array_equal(codes, want_c.numpy())
    assert np.array_equal(codes, payload.data)
    assert np.array_equal(out.view(np.int32), want_r.numpy().view(np.int32))
    assert np.array_equal(out.view(np.int32), jax_r.view(np.int32))
    # the cases reach every code: fired both ways and held
    if n >= 16:
        bits = np.unpackbits(codes[:, None], axis=1, bitorder="little")
        pairs = bits.reshape(-1, 4, 2)
        vals = set((pairs[..., 0] + 2 * pairs[..., 1]).ravel().tolist())
        assert {0, 1, 2} <= vals
