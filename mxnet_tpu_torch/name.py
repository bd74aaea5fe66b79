"""Automatic symbol naming (reference: python/mxnet/name.py).

PyTorch counterpart of ``mxnet_tpu/name.py``: ``NameManager`` assigns
``{op}{counter}`` names to anonymous symbols; ``Prefix`` prepends a scope
prefix.  Both are context managers.
"""
from __future__ import annotations

import threading


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Prepend a prefix to all names created inside the scope."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def current():
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
