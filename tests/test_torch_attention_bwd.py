"""Flash-attention backward of the PyTorch port against the JAX package.

The port's plain backward (``_flash_bwd_reference``, which a CPU tensor
takes) and its autograd Function are held against the JAX package's
Pallas backward (``_flash_bwd``, in interpret mode with 16-row blocks, so
several q and KV blocks, the causal loop bounds and the ragged-edge
masks run) and against ``jax.vjp`` of its plain attention.  Both sides
get the same q, k, v, out, lse and dO.

Tolerances:
* float32: 2e-5 absolute and relative against the Pallas backward (both
  compute in f32 and differ only in summation order; measured about
  2e-6), 1e-4 against ``jax.vjp`` of the plain attention (autodiff of a
  softmax takes another route to the same gradient);
* bfloat16 inputs: 2e-2 — both compute in f32 from the same bf16 inputs
  and round the result to bf16 once (2**-8 relative), so single
  elements may differ by one bf16 step after a near-tie.
The CUDA kernels run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt

from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import registry as treg

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
VJP_TOL = 1e-4

# B, H, Hk, Sq, Sk, D, causal
CASES = [
    (1, 2, 2, 48, 48, 32, False),    # MHA
    (1, 2, 2, 48, 48, 32, True),
    (1, 4, 2, 37, 37, 32, True),     # GQA 4 -> 2, unaligned S
    (1, 4, 1, 40, 40, 64, True),     # MQA 4 -> 1, D = 64
    (1, 4, 1, 29, 29, 64, False),
    (1, 2, 2, 20, 52, 32, True),     # causal Sq < Sk (top-left)
    (1, 2, 2, 52, 20, 32, True),     # causal Sq > Sk
    (2, 4, 2, 24, 40, 64, False),    # cross attention, GQA
    # across the card's f32 tile edges (64-row q and k tiles): Sq 80 and
    # 33, Sk 144 and 97 end a tile after 16 or 33 rows
    (1, 2, 1, 80, 144, 32, False),
    (1, 2, 2, 33, 97, 32, True),
]
IDS = ["B{}H{}Hk{}Sq{}Sk{}D{}{}".format(*c[:6], "c" if c[6] else "")
       for c in CASES]


def _inputs(case, seed):
    """q, k, v, dO (numpy f32) and the forward's out and lse."""
    B, H, Hk, Sq, Sk, D, causal = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, Hk, Sk, D).astype(np.float32)
    v = rng.randn(B, Hk, Sk, D).astype(np.float32)
    g = rng.randn(B, H, Sq, D).astype(np.float32)
    return q, k, v, g


def _jax_bwd(q, k, v, out, lse, g, causal, dtype):
    cast = (lambda x: jnp.asarray(x).astype(jnp.bfloat16)) \
        if dtype == "bfloat16" else jnp.asarray
    res = jatt._flash_bwd(cast(q), cast(k), cast(v), cast(out),
                          jnp.asarray(lse), cast(g), causal=causal,
                          block_q=16, block_k=16, interpret=True)
    return [np.asarray(r.astype(jnp.float32)) for r in res]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_kernel(case, dtype):
    causal = case[6]
    q, k, v, g = _inputs(case, seed=sum(case[:6]))
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    out, lse = tatt._attn_reference(tq, tk, tv, causal, None,
                                    return_lse=True)
    got = tatt._flash_bwd_reference(tq, tk, tv, out, lse, tg, causal, None)
    assert [t.dtype for t in got] == [tdt] * 3
    assert got[1].shape == tk.shape and got[2].shape == tv.shape
    ref = _jax_bwd(q, k, v, out.float().numpy(), lse.numpy(), g, causal,
                   dtype)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_matches_jax_vjp(case):
    """The registry op over strided views that require grad (as the
    graph's head transposes hand them over) goes through the autograd
    Function; its gradients equal ``jax.vjp`` of the plain attention."""
    causal = case[6]
    q, k, v, g = _inputs(case, seed=7 + sum(case[:6]))

    def strided(x):   # same values, (B, S, H, D) memory order
        t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
        return t.transpose(1, 2).requires_grad_()
    tq, tk, tv = strided(q), strided(k), strided(v)
    assert not tq.is_contiguous()
    out = treg.get("_contrib_FlashAttention")(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: jatt._attn_reference(a, b, c, causal,
                                                          None),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    for name, a, b in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=VJP_TOL, atol=VJP_TOL, err_msg=name)


def test_no_grad_keeps_the_lse_free_forward():
    """Serving runs without grad: the op takes the plain forward and
    records no graph, even for inputs that require grad."""
    q, k, v, _ = _inputs(CASES[2], seed=3)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = treg.get("_contrib_FlashAttention")(*t, causal=True)
    assert out.grad_fn is None
    out = treg.get("_contrib_FlashAttention")(*t, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"


def test_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never takes a CPU tensor: the CPU goes through
    the plain version by the dispatcher, not through a fallback."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(CASES[0], seed=1))
    out, lse = tatt._attn_reference(q, k, v, False, None, return_lse=True)
    with pytest.raises(tatt.MXNetError, match="CUDA"):
        tatt.flash_bwd_cuda(q, k, v, out, lse, g)
