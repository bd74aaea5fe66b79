"""Beam search over a KV-cache decode Module.

PyTorch counterpart of ``mxnet_tpu/models/generation.py``, with the same
bookkeeping and results.  The caches never leave the device: reordering
the beams is an ``nd.take`` along the batch axis of every cache state on
the module's device, skipped when the permutation is the identity.  Only
each step's logits (B*K, V) come to the host, where the top-k over the
K*V continuations runs in numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..base import MXNetError


def beam_search(dmod, prompts, beam_size, gen_len, eos: Optional[int] = None,
                length_penalty: float = 1.0):
    """Beam-search decode on a bound KV-cache decode Module.

    ``dmod`` is a Module over ``transformer_decode_step`` (or any graph
    with outputs ``[logits] + new_states`` and ``state_names`` set), bound
    with batch ``len(prompts) * beam_size`` and its parameters set; its
    states are reset here.

    ``prompts``: (B,) int array of first tokens.  Returns ``(sequences,
    scores)``: (B, beam_size, gen_len + 1) int32 and (B, beam_size)
    float32, beams sorted best-first per prompt; a score is the total
    log-probability over ``len ** length_penalty``.  With ``eos``, a
    finished beam only extends with eos at no cost, and its length counts
    up to its first eos.
    """
    from .. import ndarray as nd
    from ..context import cpu
    from ..io import DataBatch

    prompts = np.asarray(prompts)
    B = int(prompts.shape[0])
    K = int(beam_size)
    BK = B * K
    bound = dmod.data_shapes[0].shape[0]
    if bound != BK:
        raise MXNetError(
            f"beam_search: module bound with batch {bound}, need "
            f"n_prompts*beam_size = {B}*{K} = {BK}")

    dmod.set_states(value=0)
    # every beam of a prompt starts from the same token; beams 1..K-1 get
    # a -inf score so the first expansion draws K distinct continuations
    # from beam 0
    tok = np.repeat(prompts.astype("float32"), K)            # (B*K,)
    cum = np.full((B, K), -np.inf, np.float32)
    cum[:, 0] = 0.0
    seqs = np.repeat(prompts.astype(np.int64), K).reshape(B, K, 1)
    alive = np.ones((B, K), bool)

    for _step in range(gen_len):
        dmod.forward(DataBatch([nd.array(tok, ctx=cpu())], []))
        outs = dmod.get_outputs()
        logits = outs[0].asnumpy().astype(np.float32)        # (B*K, V)
        V = logits.shape[1]
        m = logits.max(axis=1, keepdims=True)
        logp = logits - m - np.log(
            np.exp(logits - m).sum(axis=1, keepdims=True))
        logp = logp.reshape(B, K, V)
        if eos is not None:
            fin = ~alive
            if fin.any():
                logp[fin] = -np.inf
                logp[fin, eos] = 0.0

        total = cum[:, :, None] + logp                       # (B, K, V)
        flat = total.reshape(B, K * V)
        top = np.argpartition(flat, -K, axis=1)[:, -K:]      # unsorted
        order = np.argsort(-np.take_along_axis(flat, top, 1), axis=1)
        top = np.take_along_axis(top, order, 1)
        parent = top // V                                    # (B, K)
        token = top % V
        cum = np.take_along_axis(flat, top, 1)

        gidx = (parent + np.arange(B)[:, None] * K).reshape(-1)
        if np.array_equal(gidx, np.arange(BK)):
            dmod.set_states(states=list(outs[1:]))
        else:
            new_states = []
            for s in outs[1:]:
                if s.ndim == 0 or s.shape[0] != BK:
                    new_states.append(s)
                else:
                    new_states.append(nd.take(s, gidx, axis=0))
            dmod.set_states(states=new_states)

        seqs = np.concatenate(
            [np.take_along_axis(seqs, parent[:, :, None], 1),
             token[:, :, None].astype(np.int64)], axis=2)
        if eos is not None:
            alive = np.take_along_axis(alive, parent, 1) & (token != eos)
            if not alive.any():
                break
        tok = token.reshape(-1).astype("float32")

    if seqs.shape[2] < gen_len + 1:
        # every beam finished early: pad with eos to (B, K, gen_len + 1)
        pad = np.full((B, K, gen_len + 1 - seqs.shape[2]), eos, np.int64)
        seqs = np.concatenate([seqs, pad], axis=2)

    lengths = seqs.shape[2] - 1
    if eos is not None:
        eff = np.full((B, K), lengths, np.float32)
        for b in range(B):
            for k in range(K):
                hits = np.where(seqs[b, k, 1:] == eos)[0]
                if hits.size:
                    eff[b, k] = float(hits[0] + 1)
        lengths = eff
    scores = cum / np.maximum(np.asarray(lengths, np.float32),
                              1.0) ** length_penalty
    order = np.argsort(-scores, axis=1)
    seqs = np.take_along_axis(seqs, order[:, :, None], 1)
    scores = np.take_along_axis(scores, order, 1)
    return seqs.astype(np.int32), scores.astype(np.float32)
