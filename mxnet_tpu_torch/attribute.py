"""Symbol attribute scoping (reference: python/mxnet/attribute.py).

PyTorch counterpart of ``mxnet_tpu/attribute.py``: ``AttrScope`` attaches
user attributes (``__lr_mult__``, ``__wd_mult__``, ``ctx_group``, ...)
to every symbol created inside the scope.  An explicit ``attr=`` of a
symbol call merges over the ambient scope's attributes, and nested
scopes merge over their parents.  Scopes are per thread.
"""
from __future__ import annotations

import threading


class AttrScope:
    """``with AttrScope(lr_mult="0.1"):`` gives every symbol created in
    the block those attributes (values must be strings)."""

    _current = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """The scope's attributes with ``attr`` merged over them, as a new
        dict (callers mutate it)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        self._old_scope = current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        assert self._old_scope is not None
        AttrScope._current.value = self._old_scope


def current() -> AttrScope:
    """The innermost scope of this thread (an empty one outside any)."""
    if not hasattr(AttrScope._current, "value"):
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
