"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
against their plain versions, and the serving slice on ``cuda:0``.  They
need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip without one.
This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import attention as att, elemwise
from mxnet_tpu_torch.serving import BucketedPredictor
import torch_threads  # noqa: F401,E402  a worker's share of the cores

pytestmark = pytest.mark.cuda

# kernel vs plain version on the same inputs; both compute in f32, and a
# bf16 output may differ by the rounding of a near-tie (2**-8 relative)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# B, H, Hk, Sq, Sk, D, causal
CASES = [
    (2, 2, 2, 48, 48, 32, False),
    (2, 2, 2, 48, 48, 32, True),
    (1, 4, 2, 37, 37, 64, True),
    (1, 4, 1, 40, 40, 64, True),
    (1, 2, 2, 20, 130, 64, True),
    (1, 2, 2, 130, 20, 32, True),
    (2, 4, 2, 70, 200, 128, False),
    (2, 4, 4, 130, 130, 128, True),
    # the edges of the bf16 tensor-core kernels, as in chip_smoke.py: MQA
    # at D 32, Sq != Sk both ways, one row, lengths off the 16-row
    # fragments, D 128 (32-row q tiles in dK/dV), GQA 8 -> 2
    (2, 4, 1, 130, 130, 32, True),
    (2, 4, 4, 100, 300, 64, True),
    (2, 4, 4, 300, 100, 64, True),
    (2, 4, 2, 1, 1, 64, True),
    (2, 4, 2, 77, 130, 64, False),
    (2, 4, 2, 130, 77, 128, True),
    (2, 8, 2, 300, 300, 64, True),
    # the bf16 dQ kernel's 64-row q tile cut off after one warp's 16 rows
    (2, 4, 2, 80, 80, 64, True),
    (1, 4, 1, 80, 144, 128, False),
    # the f32 kernels' 64-row tiles cut off after 33 rows (Sq 33, Sk 97)
    # and after half a tile (96)
    (2, 4, 2, 33, 97, 32, True),
    (1, 2, 1, 96, 96, 64, True),
]
CASE_IDS = ["B{}H{}Hk{}_Sq{}Sk{}_D{}_{}".format(
    *c[:6], "causal" if c[6] else "full") for c in CASES]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(dev, dtype, B, H, Hk, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(dev, dtype)
                 for s in ((B, H, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D)))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(dev, dtype, case):
    before = att.flash_fwd_cuda.launches
    *shape, causal = case
    q, k, v = _qkv(dev, dtype, *shape)
    out, lse = att.flash_attention(q, k, v, causal, None, return_lse=True)
    ref, ref_lse = att._attn_reference(q, k, v, causal, None,
                                       return_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    assert att.flash_fwd_cuda.launches == before + 1


def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 2, 2, 16, 16, 48)
    with pytest.raises(mt.MXNetError, match="head dim"):
        att.flash_fwd_cuda(q, k, v)
    q, k, v = _qkv(dev, torch.float16, 1, 2, 2, 16, 16, 64)
    with pytest.raises(mt.MXNetError, match="dtype"):
        att.flash_fwd_cuda(q, k, v)
    q, k, v = _qkv(dev, torch.float32, 1, 2, 2, 16, 16, 64)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        att.flash_fwd_cuda(q.transpose(1, 2), k, v)
    # the op makes strided views contiguous itself
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    out = mt.ops.registry.get("_contrib_FlashAttention")(
        strided, k, v, causal=True)
    torch.testing.assert_close(out, att._attn_reference(q, k, v, True, None),
                               rtol=1e-4, atol=1e-4)
    # bf16 rows are copied in 16-byte chunks: a contiguous view that
    # starts 2 bytes into its storage is refused
    flat = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(1, 2, 16, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(mt.MXNetError, match="16-byte"):
        att.flash_fwd_cuda(q, q, q)


def test_small_lm_served_on_card_matches_cpu(dev):
    """fp32 on the card (kernel) against the CPU (plain path), in
    log-probability within 1e-4; every dispatch launches the kernel once
    per layer."""
    V, S, L = 50, 64, 2
    net = mt.models.transformer_lm(V, S, num_layers=L, d_model=128,
                                   num_heads=4, num_kv_heads=2)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(1, S), softmax_label=(1, S))[0]))
    rng = np.random.default_rng(1)
    params = {n: (rng.standard_normal(s, dtype=np.float32) * 0.1)
              for n, s in shapes.items()
              if n not in ("data", "softmax_label")}
    req = {"data": rng.integers(0, V, (3, S), dtype=np.int32),
           "softmax_label": np.zeros((3, S), np.float32)}
    outs = {}
    for name, ctx in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        pred = BucketedPredictor(net, {"data": (S,), "softmax_label": (S,)},
                                 params, buckets=[2, 4], ctx=ctx,
                                 data_dtypes={"data": np.int32})
        before = att.flash_fwd_cuda.launches
        outs[name] = pred.predict(req)[1][0]
        assert att.flash_fwd_cuda.launches - before == (
            L if name == "card" else 0)
    diff = np.abs(np.log(outs["card"]) - np.log(outs["cpu"])).max()
    assert diff <= 1e-4, diff


# backward kernels against their plain version: both accumulate in f32;
# dK/dV sum up to Sq terms (times G under GQA), so float32 gets 1e-3 on
# gradients of order 1-10, and a bf16 output one bf16 rounding (2**-8
# relative) on top
BWD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


def _bwd_inputs(dev, dtype, case, seed):
    *shape, causal = case
    q, k, v = _qkv(dev, dtype, *shape, seed=seed)
    out, lse = att.flash_fwd_cuda(q, k, v, causal, None, return_lse=True)
    g = torch.from_numpy(np.random.default_rng(100 + seed).standard_normal(
        tuple(q.shape), dtype=np.float32)).to(dev, dtype)
    return q, k, v, out, lse, g, causal


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_version(dev, dtype, case):
    before = (att.flash_bwd_cuda.dq_launches, att.flash_bwd_cuda.dkv_launches)
    args = _bwd_inputs(dev, dtype, case, CASES.index(case))
    got = att.flash_bwd_cuda(*args)
    ref = att._flash_bwd_reference(*args, None)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == b.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(),
                                   rtol=BWD_TOL[dtype],
                                   atol=BWD_TOL[dtype], msg=name)
    assert (att.flash_bwd_cuda.dq_launches,
            att.flash_bwd_cuda.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)


DET_CASES = (2, 12, 14, 15, 17, 18)


@pytest.mark.parametrize("case", [CASES[i] for i in DET_CASES],
                         ids=[CASE_IDS[i] for i in DET_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(dev, dtype, case):
    """No atomics: two launches of K1 (with lse) and of the backward on
    the same inputs give the same bits, in both dtypes."""
    q, k, v, out, lse, g, causal = _bwd_inputs(dev, dtype, case, 0)
    out2, lse2 = att.flash_fwd_cuda(q, k, v, causal, None, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    first = att.flash_bwd_cuda(q, k, v, out, lse, g, causal)
    second = att.flash_bwd_cuda(q, k, v, out, lse, g, causal)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_autograd_function_launches_backward_kernels(dev):
    """The registry op over strided views with requires_grad: gradients
    through K1 (with lse), K2 and K3 against autograd of the plain
    attention, in float32."""
    q, k, v = _qkv(dev, torch.float32, 2, 4, 2, 70, 70, 64)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             .requires_grad_() for t in (q, k, v)]
    before = att.flash_bwd_cuda.dq_launches
    out = mt.ops.registry.get("_contrib_FlashAttention")(*views,
                                                         causal=True)
    g = torch.ones_like(out).transpose(1, 2).contiguous().transpose(1, 2)
    out.backward(g)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    att._attn_reference(*leaves, True, None).backward(g)
    for a, b in zip(views, leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-3, atol=1e-3)
    assert att.flash_bwd_cuda.dq_launches == before + 1


def test_backward_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 2, 2, 16, 16, 64)
    out, lse = att.flash_fwd_cuda(q, k, v, True, None, return_lse=True)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        att.flash_bwd_cuda(q, k, v, out, lse, out.transpose(2, 3), True)
    with pytest.raises(mt.MXNetError, match="lse"):
        att.flash_bwd_cuda(q, k, v, out, lse.double(), out, True)
    with pytest.raises(mt.MXNetError, match="dtype"):
        att.flash_bwd_cuda(q, k, v, out, lse, out.bfloat16(), True)
    # the f32 backward copies rows in 16-byte chunks too: a contiguous
    # f32 view 4 bytes into its storage is refused
    flat = torch.zeros(q.numel() + 1, device=dev)
    g = flat[1:].view(q.shape)
    assert g.is_contiguous() and g.data_ptr() % 16
    with pytest.raises(mt.MXNetError, match="16-byte"):
        att.flash_bwd_cuda(q, k, v, out, lse, g, True)


def _relu_gradient_penalty(x, w1, w2):
    """``sum(gx * gx)`` of ``gx = d sum(y * y) / dx`` taken with
    ``create_graph`` through ``Activation(act_type='relu')``, back to
    ``x``: ``gx`` and ``x``'s gradient."""
    xs = mt.nd.array(x)
    xs.attach_grad()
    with mt.autograd.record():
        h = mt.nd.Activation(mt.nd.FullyConnected(
            xs, mt.nd.array(w1), no_bias=True, num_hidden=w1.shape[0]),
            act_type="relu")
        y = mt.nd.FullyConnected(h, mt.nd.array(w2), no_bias=True,
                                 num_hidden=w2.shape[0])
        gx, = mt.autograd.grad((y * y).sum(), [xs], create_graph=True)
        pen = (gx * gx).sum()
    pen.backward()
    return [gx.asnumpy(), xs.grad.asnumpy()]


def test_second_order_through_relu_on_card_equals_cpu(dev):
    """The relu's backward on the card (R1) stays differentiable: a
    gradient penalty through ``Activation(act_type='relu')`` equals the
    CPU's (whose plain backward the JAX package holds,
    ``test_torch_grad_sweep.py``), float32 with TF32 off, rtol 1e-5 and
    atol 1e-5 of the largest value (sums of up to 128 terms).
    R1 runs three times: the first-order backward, then the relu's
    gradient's own backward and the relu's again under ``pen``."""
    rng = np.random.default_rng(16)
    x, w1, w2 = (rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(s[1])
                 for s in ((64, 96), (128, 96), (32, 128)))
    with mt.cpu():
        want = _relu_gradient_penalty(x, w1, w2)
    before = elemwise.relu_grad_cuda.launches
    got = _relu_gradient_penalty(x, w1, w2)
    assert elemwise.relu_grad_cuda.launches == before + 3
    assert np.abs(want[1]).max() > 1e-3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
