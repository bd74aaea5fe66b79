"""Chunked LM-head cross-entropy (``_contrib_ChunkedLMLoss``, alias
``chunked_lm_loss``): the LM head's product and the softmax
cross-entropy over vocabulary chunks, so the (N, V) logits never exist
whole.

PyTorch counterpart of ``mxnet_tpu/ops/chunked_loss.py``, as a
``torch.autograd.Function`` where the JAX package has a ``custom_vjp``.
The forward keeps an online log-sum-exp over the chunks (the flash
attention trick along the vocabulary); the backward recomputes each
chunk's logits and forms softmax - onehot, scaled by the incoming
gradient.  Peak memory is O(N * V / chunks).

The vocabulary is cut into ``num_chunks`` chunks of ceil(V / chunks)
rows; the JAX package pads the last with zero rows of bias -inf, which
add exp(-inf) = 0 to every sum and are never a label, so here the last
chunk is simply shorter.  Logits are float32 from operands of the
inputs' dtype, as ``preferred_element_type=jnp.float32`` gives: bf16
operands go through ``torch.mm(..., out_dtype=torch.float32)`` on the
card (products of bf16 values are exact in float32, summed in float32);
on the CPU the operands are cast to float32 first, which gives the same
products.  The backward's products run in float32, dW and db are
written in float32 and cast to the weight's dtype, dh is accumulated in
float32 and cast to the hidden's.  Float64 inputs run in float64
throughout.  The chunk products are cuBLAS calls:
the JAX package computes them outside any Pallas kernel too.
"""
from __future__ import annotations

import torch

from .registry import register


def _logits(h, w, b):
    """(N, rows) logits of one chunk: float32 from bf16 / fp16 operands,
    else in the operands' dtype."""
    if h.dtype not in (torch.bfloat16, torch.float16):
        return h @ w.t() + b
    if h.is_cuda:
        z = torch.mm(h, w.t(), out_dtype=torch.float32)
    else:
        z = h.float() @ w.float().t()
    return z + b.float()


def _acc(t):
    """The dtype sums run in: float64 for float64 inputs, else float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _chunks(v, num_chunks):
    """The (start, stop) rows of each chunk of a vocabulary of ``v``."""
    vc = -(-v // num_chunks)
    return [(c * vc, min(v, (c + 1) * vc)) for c in range(num_chunks)
            if c * vc < v]


class ChunkedLMLoss(torch.autograd.Function):
    """loss (N,) float32 = lse(h W^T + b) - (h W^T + b)[label]."""

    @staticmethod
    def forward(ctx, h, w, b, label, num_chunks):
        n, acc = h.shape[0], _acc(h)
        lab = label.long()
        m = torch.full((n,), float("-inf"), dtype=acc, device=h.device)
        se = torch.zeros((n,), dtype=acc, device=h.device)
        ll = torch.zeros((n,), dtype=acc, device=h.device)
        for lo, hi in _chunks(w.shape[0], num_chunks):
            z = _logits(h, w[lo:hi], b[lo:hi])
            m_new = torch.maximum(m, z.amax(dim=-1))
            se = se * torch.exp(m - m_new) \
                + torch.exp(z - m_new[:, None]).sum(dim=-1)
            idx = lab - lo
            hit = (idx >= 0) & (idx < hi - lo)
            picked = z.gather(1, idx.clamp(0, hi - lo - 1)[:, None])[:, 0]
            ll = ll + torch.where(hit, picked, 0.0)
            m = m_new
        lse = m + torch.log(se)
        ctx.num_chunks = num_chunks
        ctx.save_for_backward(h, w, b, lab, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        h, w, b, lab, lse = ctx.saved_tensors
        acc = _acc(h)
        gf, hf = g.to(acc), h.to(acc)
        dh = torch.zeros(h.shape, dtype=acc, device=h.device)
        dw = torch.empty(w.shape, dtype=acc, device=w.device)
        db = torch.empty(b.shape, dtype=acc, device=b.device)
        for lo, hi in _chunks(w.shape[0], ctx.num_chunks):
            p = torch.exp(_logits(h, w[lo:hi], b[lo:hi]) - lse[:, None])
            idx = lab - lo
            hit = (idx >= 0) & (idx < hi - lo)
            p.scatter_add_(1, idx.clamp(0, hi - lo - 1)[:, None],
                           -hit.to(acc)[:, None])       # softmax - onehot
            p.mul_(gf[:, None])
            dh.addmm_(p, w[lo:hi].to(acc))
            torch.mm(p.t(), hf, out=dw[lo:hi])
            db[lo:hi] = p.sum(dim=0)
        return (dh.to(h.dtype), dw.to(w.dtype), db.to(b.dtype), None, None)


def chunked_lm_loss(hidden, weight, bias, label, num_chunks=8):
    """Per-token CE loss (N,) for hidden (N, D) against the LM head's
    weight (V, D) and bias (V,); the (N, V) logits never exist."""
    if hidden.device.type == "meta":
        return torch.empty(hidden.shape[:1], device="meta")
    return ChunkedLMLoss.apply(hidden, weight, bias, label, int(num_chunks))


@register("_contrib_ChunkedLMLoss",
          arg_names=["data", "weight", "bias", "label"],
          attr_defaults={"num_chunks": 8},
          aliases=("chunked_lm_loss",))
def _chunked_lm_loss_op(data, weight, bias, label, num_chunks=8, **kw):
    """Per-token CE loss (N,) for hidden (N, D) against the LM head's
    weight (V, D) and bias (V,); the full logits never exist."""
    return chunked_lm_loss(data, weight, bias, label, num_chunks)
