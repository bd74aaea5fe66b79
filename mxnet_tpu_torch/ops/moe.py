"""Mixture-of-experts feed-forward (``_contrib_MoE``, alias ``moe_ffn``).

PyTorch counterpart of ``mxnet_tpu/ops/moe.py`` with the same function:
softmax gating over the experts, top-k by repeated first-maximum argmax,
the selected gates renormalised to sum to 1, an expert capacity of
``max(1, int(capacity_factor * T * k / E))`` tokens, each token given the
next free slot of each of its experts in token order, tokens past an
expert's capacity dropped (combine weight 0, so only the residual carries
them), and experts ``relu`` or ``gelu`` (the tanh approximation, as
``jax.nn.gelu``) FFNs.

The JAX package builds (T, E, C) one-hot dispatch and combine tensors and
routes with einsums.  Here the routing is indices: the kept tokens are
gathered into an (E, C, d) expert-major buffer (an empty slot reads a
zero row), the experts run as two batched products, and each token's
outputs are weighted by its gates and added back with ``index_add``.  The
function and its gradients are the same; nothing of size T x E x C is
built.  The slot positions are an integer running count, exact at any
T: the JAX package counts in the gates' dtype, which under bf16 stops
being exact past 256 tokens an expert (ROADMAP §3).  On the card the
backward of ``index_select`` / ``index_add`` adds with atomics, so it is
not bit-reproducible from run to run.

At k = 1 each gate is p / p = 1, so no gradient reaches the router's
weight through the gates, in both packages.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .registry import register


def capacity_of(tokens, k, num_experts, capacity_factor=2.0):
    """Slots an expert: ``max(1, int(capacity_factor * T * k / E))``."""
    return max(1, int(capacity_factor * tokens * k / num_experts))


def top_k_route(logits, k, capacity):
    """logits (T, E) -> (experts, slots, keep, gates), each (T, k).

    ``experts`` are the k chosen experts of each token (the first maximum
    of what is left, k times); ``slots`` the token's position in each
    expert's capacity, counted over the tokens in order (int64, exact);
    ``keep`` whether that position lies within ``capacity``; ``gates``
    the chosen probabilities over their sum (at least 1e-9), in the
    logits' dtype and differentiable."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    work = probs.detach()
    picks = []
    for _ in range(k):
        sel = torch.argmax(work, dim=-1)          # the first maximum
        picks.append(sel)
        work = work.scatter(1, sel[:, None], float("-inf"))
    experts = torch.stack(picks, dim=1)          # (T, k)
    # expert-major (E, T), so the running count scans each expert's row
    chosen = torch.zeros((E, T), dtype=torch.int64, device=logits.device)
    chosen.scatter_(0, experts.t(), 1)
    pos = torch.cumsum(chosen, dim=1) - 1         # exact
    slots = pos.gather(0, experts.t()).t()
    keep = slots < capacity
    p = probs.gather(1, experts)
    gates = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-9)
    return experts, slots, keep, gates


def moe_ffn(x, gate_w, w1, b1, w2, b2, num_experts, k=1,
            capacity_factor=2.0, activation="relu", stats=None):
    """x (..., d); gate_w (d, E); w1 (E, d, f), b1 (E, f), w2 (E, f, d),
    b2 (E, d) -> (..., d).  ``stats``, a dict, receives the routing's
    counts (tokens, capacity, dropped choices, tokens an expert) where
    the caller wants them."""
    if x.device.type == "meta":
        return torch.empty_like(x)
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    T, E = xt.shape[0], int(num_experts)
    C = capacity_of(T, k, E, capacity_factor)
    experts, slots, keep, gates = top_k_route(xt @ gate_w, int(k), C)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, int(k))
    # each choice's slot; a dropped one points past the last slot (no
    # boolean indexing, so the card never waits for the host)
    flat = torch.where(keep, experts * C + slots, E * C)
    # slot -> token (T: the zero row past the tokens), then one gather
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.int64,
                          device=x.device)
    slot_tok[flat.reshape(-1)] = tok.reshape(-1)
    xpad = torch.cat([xt, xt.new_zeros(1, d)])
    expert_in = xpad.index_select(0, slot_tok[:E * C]).view(E, C, d)
    h = torch.bmm(expert_in, w1) + b1[:, None, :]
    if activation == "relu":
        h = torch.relu(h)
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    out_e = (torch.bmm(h, w2) + b2[:, None, :]).view(E * C, d)
    # each choice's output times its gate (0 where dropped), summed a
    # token in f32 (f64 for f64 inputs) and rounded once, as the JAX
    # package's combine einsum accumulates its products
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    weight = (gates * keep).to(acc).reshape(-1, 1)
    contrib = out_e.index_select(
        0, flat.clamp(max=E * C - 1).reshape(-1)).to(acc) * weight
    out = torch.zeros((T, d), dtype=acc, device=x.device)
    out = out.index_add(0, tok.reshape(-1), contrib).to(x.dtype)
    if stats is not None:
        _note(stats, T, C, E, experts, keep)
    return out.reshape(shape)


def _note(stats, T, C, E, experts, keep):
    stats["tokens"] = stats.get("tokens", 0) + T
    stats["choices"] = stats.get("choices", 0) + int(keep.numel())
    stats["capacity"] = C
    stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
    load = torch.bincount(experts.reshape(-1), minlength=E).cpu()
    stats["load"] = stats["load"] + load if "load" in stats else load
    # per call, the tokens (in the call's order) with a choice dropped,
    # and every token's experts
    stats.setdefault("dropped_tokens", []).append(
        (~keep).any(dim=1).cpu())
    stats.setdefault("experts", []).append(experts.cpu())


@register("_contrib_MoE",
          arg_names=["data", "gate_weight", "expert_w1", "expert_b1",
                     "expert_w2", "expert_b2"],
          aliases=("moe_ffn",),
          attr_defaults={"num_experts": 0, "k": 1,
                         "capacity_factor": 2.0, "activation": "relu"})
def _moe_op(data, gate_weight, expert_w1, expert_b1, expert_w2, expert_b2,
            num_experts=0, k=1, capacity_factor=2.0, activation="relu",
            **kw):
    """MoE FFN for nd / sym / Gluon; ``num_experts`` defaults to
    gate_weight's last dimension."""
    E = int(num_experts) or int(gate_weight.shape[-1])
    return moe_ffn(data, gate_weight, expert_w1, expert_b1, expert_w2,
                   expert_b2, E, int(k), float(capacity_factor), activation,
                   stats=getattr(_routing, "stats", None))


# this thread's dict of routing counts while it collects them
_routing = threading.local()


class collect_routing:
    """``with collect_routing() as s:`` gathers, over every ``_contrib_MoE``
    call inside, the tokens and choices routed, the choices dropped past
    capacity, each expert's load (choices routed to it), the last call's
    capacity, and per call a (T,) mask of the tokens with a choice
    dropped and the (T, k) experts chosen (a dict: ``tokens``,
    ``choices``, ``dropped``, ``load``, ``capacity``, ``dropped_tokens``,
    ``experts``), in this thread.  Each call then waits for the card to
    read them."""

    def __enter__(self):
        self._prev = getattr(_routing, "stats", None)
        _routing.stats = {}
        return _routing.stats

    def __exit__(self, *exc):
        _routing.stats = self._prev
        return False
