"""The port's gradient compression against the JAX package's
(``mxnet_tpu/compression.py``): Q1's plain version
``quantize_2bit_plain`` equals the numpy ``quantize_2bit`` bit for bit
in codes and residual (random gradients at many lengths, every code,
NaN, +-inf, +-0, subnormals, +-t exactly and its neighbours, t 0.5 and
0.1, which float32 cannot hold, with and without a residual, float64
input), the compressor routes a CPU tensor and a numpy array to it and
keeps the residual per wire key, ``compress_rows`` and ``decompress``
equal the JAX package's, the validation messages are the JAX package's,
and the card wrapper refuses a CPU tensor instead of falling back."""
import numpy as np
import pytest
import torch

import mxnet_tpu.compression as jc
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import compression as tc
import torch_threads  # noqa: F401,E402  a worker's share of the cores


def _specials(t):
    t32 = np.float32(t)
    return np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-42,
                     t32, -t32, np.nextafter(t32, np.float32(0)),
                     -np.nextafter(t32, np.float32(0)),
                     np.nextafter(t32, np.float32(1e9)), 2 * t32],
                    np.float32)


def _case(n, t, seed):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * t * 1.5).astype(np.float32)
    sp = _specials(t)
    k = min(n, sp.size)
    g[rng.permutation(n)[:k]] = sp[:k]
    r = (rng.randn(n) * t * 0.6).astype(np.float32)
    return g, r


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("t", [0.5, 0.1, 3e-3])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 15, 16, 17, 1000, 4099])
def test_quantize_2bit_plain_equals_the_jax_package(n, t):
    g, r = _case(n, t, seed=n)
    for res in (None, r):
        payload, want = jc.quantize_2bit(g, res, t)
        codes, got = tc.quantize_2bit_plain(
            torch.from_numpy(g), None if res is None else
            torch.from_numpy(res), t)
        assert codes.dtype == torch.uint8 and codes.numel() == (n + 3) // 4
        np.testing.assert_array_equal(codes.numpy(), payload.data)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the 2-D, float64 and JAX-named entry points agree too
    g2 = g.astype(np.float64).reshape(1, -1)
    p1, w1 = jc.quantize_2bit(g2.astype(np.float32), r.reshape(1, -1), t)
    p2, w2 = tc.quantize_2bit(g2.astype(np.float32), r.reshape(1, -1), t)
    assert p2.shape == p1.shape == (1, n) and p2.threshold == p1.threshold
    np.testing.assert_array_equal(p2.data, p1.data)
    np.testing.assert_array_equal(_bits(w2), _bits(w1))


def test_every_code_and_special_lands_as_the_jax_package():
    t = 0.1
    g = _specials(t)
    payload, want = jc.quantize_2bit(g, None, t)
    codes, got = tc.quantize_2bit_plain(torch.from_numpy(g), None, t)
    np.testing.assert_array_equal(codes.numpy(), payload.data)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    unpacked = np.stack([(payload.data >> (2 * i)) & 3 for i in range(4)],
                        axis=1).ravel()[:g.size]
    # NaN holds, +-inf and +-t fire, -0 holds with its sign
    assert list(unpacked[:9]) == [0, 1, 2, 0, 0, 0, 0, 1, 2]
    assert np.signbit(got.numpy()[4]) and got.numpy()[3] == 0
    assert np.isnan(got.numpy()[0])


@pytest.mark.parametrize("ctype", ["2bit", "fp16", "none"])
def test_compressor_routes_cpu_tensors_and_numpy_as_the_jax_package(ctype):
    """Three pushes of one wire key and one of another: the payloads and
    the residuals equal the JAX compressor's; non-float payloads and an
    inactive setting pass through; float64 is cast to float32."""
    params = {"type": ctype, "threshold": 0.25}
    jgc, tgc = jc.GradientCompression(params), tc.GradientCompression(params)
    jres, tres = {}, {}
    rng = np.random.RandomState(5)
    for step in range(4):
        key = "w" if step < 3 else "v@s1"
        g = rng.randn(3, 7).astype(np.float64 if step == 1 else np.float32)
        want = jgc.compress(key, g, jres)
        for arg in (torch.from_numpy(g), g):
            got = tgc.compress(key, arg, dict(tres))
        got = tgc.compress(key, torch.from_numpy(g), tres)
        if ctype == "none":
            assert got.dtype == torch.from_numpy(g).dtype
            continue
        assert (got.kind, got.shape, got.threshold) == \
            (want.kind, want.shape, want.threshold)
        np.testing.assert_array_equal(got.data, want.data)
    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_array_equal(_bits(tres[k].numpy()),
                                      _bits(jres[k]))
    ints = np.arange(6, dtype=np.int32)
    assert tgc.compress("i", ints, {}) is ints
    ti = torch.arange(6, dtype=torch.int32)
    assert tgc.compress("i", ti, {}) is ti


@pytest.mark.parametrize("ctype", ["2bit", "fp16"])
def test_compress_rows_and_decompress_equal_the_jax_package(ctype):
    params = {"type": ctype, "threshold": 0.5}
    jgc, tgc = jc.GradientCompression(params), tc.GradientCompression(params)
    jbank, tbank = {}, {}
    rng = np.random.RandomState(9)
    for _ in range(3):
        ids = np.sort(rng.choice(20, 5, replace=False)).astype(np.int64)
        rows = (rng.randn(5, 3) * 0.4).astype(np.float32)
        want = jgc.compress_rows(ids, rows, jbank)
        got = tgc.compress_rows(ids, rows, tbank)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(tc.decompress(got),
                                      jc.decompress(want))
    assert set(jbank) == set(tbank)
    for k in jbank:
        np.testing.assert_array_equal(_bits(tbank[k]), _bits(jbank[k]))
    with pytest.raises(mt.MXNetError, match="kind"):
        tc.decompress(tc.WirePayload("3bit", (1,), 0.5, np.zeros(1)))


@pytest.mark.parametrize("params", [
    {"type": "3bit"}, {"type": "2bit", "threshold": 0.0},
    {"type": "2bit", "threshold": -1}, {"type": "2bit", "bogus": 1}])
def test_validation_messages_are_the_jax_package(params):
    with pytest.raises(jc.MXNetError) as jerr:
        jc.GradientCompression(params)
    with pytest.raises(mt.MXNetError) as terr:
        tc.GradientCompression(params)
    assert str(terr.value) == str(jerr.value)


def test_rowsparse_validation_and_payload_pickles_match():
    import pickle
    ok = tc.RowSparsePayload(np.array([1, 4], np.int64), 8,
                             np.ones((2, 3), np.float32))
    assert tc.validate_rowsparse(ok) is ok
    for bad in (tc.RowSparsePayload(np.array([4, 1], np.int64), 8,
                                    np.ones((2, 3), np.float32)),
                tc.RowSparsePayload(np.array([9], np.int64), 8,
                                    np.ones((1, 3), np.float32))):
        with pytest.raises(ValueError) as terr:
            tc.validate_rowsparse(bad)
        with pytest.raises(ValueError) as jerr:
            jc.validate_rowsparse(jc.RowSparsePayload(bad.indices,
                                                      bad.nrows, bad.data))
        assert str(terr.value) == str(jerr.value)
    p = pickle.loads(pickle.dumps(tc.WirePayload("2bit", (3,), 0.5,
                                                 np.zeros(1, np.uint8))))
    assert (p.kind, p.shape, p.threshold) == ("2bit", (3,), 0.5)


def test_card_wrapper_refuses_what_it_does_not_take():
    """Q1's wrapper raises on a CPU tensor (no silent fallback to the
    plain version) before it looks for the kernel."""
    g = torch.zeros(8)
    with pytest.raises(mt.MXNetError, match="card"):
        tc.quantize_2bit_cuda(g, None, 0.5)
    assert tc.quantize_2bit_cuda.launches == 0
