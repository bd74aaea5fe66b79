"""Gluon contrib blocks of the JAX package with no reference analog.

``ChunkedLMHead`` is the Gluon face of ``ops/chunked_loss.py``: the LM
head's projection and softmax cross-entropy fused over vocabulary
chunks, so the (N, V) logits never exist whole.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock


class ChunkedLMHead(HybridBlock):
    """Fused lm-head projection + per-token CE loss over vocab chunks
    (``ops/chunked_loss.py``: the flash-attention trick along vocab).

    Call with (hidden (N, in_units), label (N,)) → per-token loss (N,).
    Parameters are named ``weight``/``bias`` like Dense, so a trained
    head's weights load straight into a Dense of the same shape for
    full-logits inference.

    ``in_units`` is REQUIRED (unlike Dense): the loss op has no
    symbolic shape hook to back-fill a deferred weight, and the head's
    input width is always known where an LM is assembled.
    """

    def __init__(self, vocab_size, in_units, num_chunks=8,
                 dtype=np.float32, weight_initializer=None,
                 bias_initializer='zeros', **kwargs):
        super().__init__(**kwargs)
        if int(num_chunks) < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        if int(in_units) < 1:
            raise ValueError(
                f"in_units must be a known positive width, got {in_units}"
                " (ChunkedLMHead does not support deferred shape init)")
        self._chunks = int(num_chunks)
        with self.name_scope():
            self.weight = self.params.get(
                'weight', shape=(int(vocab_size), int(in_units)),
                dtype=dtype, init=weight_initializer)
            self.bias = self.params.get(
                'bias', shape=(int(vocab_size),), dtype=dtype,
                init=bias_initializer)

    def hybrid_forward(self, F, hidden, label, weight, bias):
        return F.chunked_lm_loss(hidden, weight, bias, label,
                                 num_chunks=self._chunks)
