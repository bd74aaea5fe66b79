"""Core plumbing shared by every layer of mxnet_tpu_torch.

PyTorch counterpart of ``mxnet_tpu/base.py``: the package's error type,
the typed environment-knob registry and the ``contrib`` namespace helper.
Only the knobs this package reads are declared here.
"""
from __future__ import annotations

import os
from typing import Dict

__version__ = "0.12.0.torch0"


class MXNetError(RuntimeError):
    """Default error raised by mxnet_tpu_torch (mirrors mxnet.base.MXNetError)."""


# ---------------------------------------------------------------------------
# Runtime flag registry (reference: dmlc::GetEnv call sites).  Every env
# flag the package consults is declared here with a type, a default and a
# description.
# ---------------------------------------------------------------------------
_ENV_FLAGS: Dict[str, tuple] = {}


def declare_env(name: str, typ: type, default, doc: str = "") -> None:
    _ENV_FLAGS[name] = (typ, default, doc)


def env(name: str, default=None):
    """Typed environment-variable lookup (reference: dmlc::GetEnv)."""
    if name in _ENV_FLAGS:
        typ, declared_default, _ = _ENV_FLAGS[name]
        if default is None:
            default = declared_default
    else:
        typ = type(default) if default is not None else str
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() not in ("0", "false", "off", "")
    try:
        return typ(raw)
    except (TypeError, ValueError):
        return default


declare_env("MXNET_SERVING_BUCKETS", str, "1,2,4,8,16,32",
            "serving: comma-separated batch-size buckets the predictor "
            "serves (requests pad to the smallest covering bucket)")
declare_env("MXNET_SERVING_MAX_WAIT_MS", float, 2.0,
            "serving: dynamic batcher max wait for more requests before "
            "dispatching a partially-filled bucket (0 dispatches "
            "immediately)")
declare_env("MXNET_SERVING_QUEUE_DEPTH", int, 256,
            "serving: admission control — requests queued past this "
            "depth are shed with a typed BUSY reply")


class ContribNamespace:
    """``mx.sym.contrib.X`` → registered ``_contrib_X`` op (reference:
    python/mxnet/symbol/contrib.py namespace)."""

    def __init__(self, ns):
        self._ns = ns

    def __getattr__(self, name):
        fn = self._ns.get("_contrib_" + name) or self._ns.get(name)
        if fn is None:
            raise AttributeError(f"contrib op {name!r} not registered")
        return fn
