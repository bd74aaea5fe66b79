"""Flash-attention forward of the PyTorch port against the JAX package.

On the CPU the port takes the kernel's plain version; the JAX side runs
its Pallas kernel in interpret mode (small blocks, so several KV blocks,
the causal early stop and the ragged-edge masks all run).  Tolerance:
1e-5 absolute and relative in float32 — both sides compute in f32 and
differ only in summation order.  The CUDA kernel itself runs only on the
card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import registry as jreg

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import registry as treg

TOL = dict(rtol=1e-5, atol=1e-5)

# B, H, Hk, Sq, Sk, D, causal
CASES = [
    (2, 2, 2, 48, 48, 16, False),
    (2, 2, 2, 48, 48, 16, True),
    (1, 4, 2, 37, 37, 16, True),     # GQA Hk=2, unaligned S
    (1, 4, 1, 40, 40, 64, True),     # MQA Hk=1, D=64
    (1, 4, 1, 29, 29, 64, False),
    (1, 2, 2, 20, 52, 16, True),     # causal Sq < Sk (top-left)
    (1, 2, 2, 52, 20, 16, True),     # causal Sq > Sk
    (2, 4, 2, 24, 40, 64, False),    # cross attention, GQA
]


def _qkv(B, H, Hk, Sq, Sk, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, Hk, Sk, D).astype(np.float32),
            rng.randn(B, Hk, Sk, D).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=[
    "B{}H{}Hk{}Sq{}Sk{}D{}{}".format(*c[:6], "c" if c[6] else "")
    for c in CASES])
def test_plain_forward_and_lse_match_jax_kernel(case):
    B, H, Hk, Sq, Sk, D, causal = case
    q, k, v = _qkv(B, H, Hk, Sq, Sk, D, seed=sum(case[:6]))
    j_out, j_lse = jatt._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, block_q=16, block_k=16, return_lse=True)
    t_out, t_lse = tatt.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, None, return_lse=True)
    assert t_out.shape == (B, H, Sq, D) and t_lse.shape == (B, H, Sq)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


def test_explicit_scale_matches_jax_reference():
    q, k, v = _qkv(1, 2, 2, 33, 33, 16, seed=7)
    ref = jatt._attn_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), True, 0.3)
    out = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), True, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_op_takes_strided_views_like_the_graph_hands_it():
    """The graph's head transpose produces non-contiguous views; the op
    (and its aliases) must give the JAX op's result on them."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 3, 4, 16).astype(np.float32)   # (B, S, qkv, H, D)
    jop = jreg.get("_contrib_FlashAttention")
    for name in ("_contrib_FlashAttention", "flash_attention",
                 "_contrib_flash_attention"):
        top = treg.get(name)
        tx = torch.from_numpy(x)
        tq, tk, tv = (tx[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        assert not tq.is_contiguous()
        out = top(tq, tk, tv, causal=True)
        jx = jnp.asarray(x)
        jq, jk, jv = (jnp.transpose(jx[:, :, i], (0, 2, 1, 3))
                      for i in range(3))
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jop(jq, jk, jv, causal=True)),
                                   **TOL)


def test_meta_tensors_take_the_plain_path():
    q = torch.empty(2, 4, 10, 32, device="meta")
    k = torch.empty(2, 2, 12, 32, device="meta")
    out, lse = tatt.flash_attention(q, k, k, True, None, return_lse=True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 4, 10, 32)
    assert tuple(lse.shape) == (2, 4, 10)
    before = tatt.flash_fwd_cuda.launches
    tatt.flash_attention(q, k, k)
    assert tatt.flash_fwd_cuda.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(MXNetError, match="CUDA"):
        tatt.flash_fwd_cuda(q, q, q)


def test_gqa_validation_and_repeat_kv_match_jax():
    q, k, v = _qkv(1, 6, 2, 5, 5, 8, seed=1)
    tk, tv = tatt.gqa_repeat_kv(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    jk, jv = jatt.gqa_repeat_kv(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    bad = torch.zeros(1, 4, 5, 8)
    with pytest.raises(ValueError, match="divisible"):
        tatt.flash_attention(torch.zeros(1, 6, 5, 8), bad, bad)
