"""Gluon contrib blocks of the JAX package with no reference analog.

``ChunkedLMHead`` (the lm-head projection and softmax cross-entropy
fused over vocab chunks) runs the ``chunked_loss`` op, which is not
ported yet (ROADMAP C1.b); constructing it raises.
"""
from __future__ import annotations

from ...base import MXNetError


class ChunkedLMHead:
    """Not ported yet: needs the ``chunked_loss`` op (ROADMAP C1.b)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.ChunkedLMHead needs the "
                         "chunked_loss op, which is not ported yet "
                         "(ROADMAP C1.b)")
