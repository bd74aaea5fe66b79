"""KVStore: the single-process key-value store.

PyTorch counterpart of the local part of ``mxnet_tpu/kvstore.py``
(``:58-345`` and ``create``, ``:3465-3476``; reference:
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h): ``init``,
``push`` (the pushed copies summed, then the updater run on the stored
value, or the sum stored), ``pull``, ``assign``, ``row_sparse_pull`` and
update-on-kvstore through ``set_optimizer``.  ``rank`` is 0 and
``num_workers`` 1.

torch tensors are mutable where JAX arrays are not, so the store never
shares a tensor with its caller: ``init``, ``assign`` and a ``push``
without an updater store a copy, ``pull`` copies into ``out``, and an
updater rebinds the store's own array.

The distributed types (``dist_sync``, ``dist_async``, ...), gradient
compression on them, and the server processes are the distributed plane
(ROADMAP E1); each raises :class:`MXNetError` naming it.
``server_stats`` returns this process's profiler snapshot: a local store
is its own server.
"""
from __future__ import annotations

from typing import Dict

import torch

from .base import MXNetError
from .ndarray import NDArray
from . import optimizer as opt

# the store types of one process (reference: kvstore.cc:34 Create)
LOCAL_TYPES = ("local", "local_allreduce_cpu", "local_allreduce_device",
               "device", "nccl")
DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async", "dist")
# the distributed store's stripe separator (JAX package: membership.py
# STRIPE_SEP), reserved in key names here too
_STRIPE_SEP = "@s"


def _key(k):
    return str(k)


def _key_int(k):
    """An updater key: an integer name as its int, any other as itself
    (JAX package: kvstore_server.py ``_key_int``)."""
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _write_row_sparse_out(outs, rows, idx, full_shape):
    """Put gathered rows into each out array: a RowSparseNDArray is
    re-armed in place with the rows and their ids on its own device
    (nothing dense is built), a dense one becomes zeros with those rows
    set."""
    from .ndarray.sparse import RowSparseNDArray
    for o in outs:
        if isinstance(o, RowSparseNDArray):
            dev = o.data._data.device
            RowSparseNDArray.__init__(o, rows.to(dev, copy=True),
                                      idx.to(dev, copy=True),
                                      tuple(full_shape))
        else:
            dev = o._data.device
            dense = torch.zeros(tuple(full_shape), dtype=rows.dtype,
                                device=dev)
            o._set_data(dense.index_copy_(0, idx.to(dev), rows.to(dev)))


class KVStore:
    """The single-process store (reference: KVStoreLocal,
    kvstore_local.h)."""

    def __init__(self, kvtype="local"):
        self.type = kvtype
        self._store: Dict[str, NDArray] = {}
        self._updater = None
        self._optimizer = None

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value):
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"duplicate init of key {k}")
            self._store[k] = NDArray(vs[0]._data.detach().clone())

    def push(self, key, value, priority=0):
        """Sum the pushed copies of each key, then run the updater on the
        stored value, or store the sum (reference: KVStoreLocal::PushImpl,
        kvstore_local.h:149; without an updater the store holds the sum,
        kvstore_local.h:173)."""
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"push to uninitialized key {k}")
            agg = self._reduce(vs)
            if self._updater is not None:
                self._updater(_key_int(k), NDArray(agg), self._store[k])
            else:
                self._store[k]._set_data(
                    agg.clone() if len(vs) == 1 else agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each stored value into its out array(s), on their devices
        (reference: KVStoreLocal::PullImpl)."""
        assert out is not None
        keys, outs = self._canon(key, out)
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"pull of uninitialized key {k}")
            src = self._store[k]._data
            for o in os_:
                o._set_data(src.to(o._data.device, copy=True))

    def assign(self, key, value):
        """Store each value as it is, bypassing any updater, creating
        missing keys (the JAX package's control-plane register; no
        reference analog)."""
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            val = vs[0]._data.detach().clone()
            if k in self._store:
                self._store[k]._set_data(val)
            else:
                self._store[k] = NDArray(val)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` names, deduplicated and sorted
        (reference: KVStoreLocal::PullRowSparseImpl): a RowSparseNDArray
        ``out`` gets the rows and their ids, a dense one zeros with those
        rows.  The ids are made unique on the store's device, which waits
        for the count."""
        assert out is not None and row_ids is not None
        keys, outs = self._canon(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        for k, os_, rid in zip(keys, outs, row_ids):
            if _STRIPE_SEP in k:
                raise MXNetError(
                    f"kvstore {self.type}: key {k!r} contains the reserved "
                    f"stripe separator '{_STRIPE_SEP}' - rename the "
                    "parameter")
            if k not in self._store:
                raise MXNetError(f"pull of uninitialized key {k}")
            src = self._store[k]._data
            idx = torch.unique(rid._data.to(src.device, torch.int64))
            _write_row_sparse_out(os_, src.index_select(0, idx), idx,
                                  src.shape)

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store on every push (reference:
        kvstore.py:353, update-on-kvstore)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """Compression changes what a push sends over a wire; a local
        store has none and refuses it, as the reference's does.  The
        stores that compress are distributed (ROADMAP E1)."""
        if self.type.startswith("local"):
            raise MXNetError(
                "gradient compression is not supported for kvstore type "
                f"{self.type!r} (reference: local stores don't compress)")
        raise MXNetError(
            f"kvstore {self.type!r}: gradient compression rides the "
            "distributed kvstore, which is not ported yet (ROADMAP E1)")

    def barrier(self):
        """Nothing to wait for in one process."""

    def num_dead_nodes(self) -> int:
        """One process has no node to lose (reference: kvstore.h:328)."""
        return 0

    def server_stats(self, rank: int = 0) -> dict:
        """The profiler snapshot of "server" ``rank``: a store with no
        server processes is its own server, so the local process's
        ``profiler.snapshot()`` comes back (reference layout of the JAX
        package's kvstore.py:245-255)."""
        from . import profiler as _prof
        if rank != 0:
            raise MXNetError(
                f"kvstore type {self.type!r} has no server rank {rank}")
        return _prof.snapshot()

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no optimizer installed")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("there is no optimizer installed")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    @staticmethod
    def _reduce(vs):
        """The sum of the pushed copies, on the first one's device (a
        pushed sparse array is read dense, as in the JAX package)."""
        if len(vs) == 1:
            return vs[0]._data
        dev = vs[0]._data.device
        datas = [v._data.to(dev) for v in vs]
        if len(datas) == 2:
            return datas[0] + datas[1]
        return torch.sum(torch.stack(datas), dim=0)

    _key_int = staticmethod(_key_int)

    @staticmethod
    def _canon(key, value):
        single = not isinstance(key, (list, tuple))
        keys = [key] if single else list(key)
        if single:
            values = [value if isinstance(value, (list, tuple)) else [value]]
        else:
            values = [v if isinstance(v, (list, tuple)) else [v]
                      for v in value]
        return [_key(k) for k in keys], values


def create(name="local") -> KVStore:
    """A store of type ``name`` (reference: kvstore.py:534 create ->
    KVStore::Create, kvstore.cc:34)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in LOCAL_TYPES:
        return KVStore(name)
    if name in DIST_TYPES:
        raise MXNetError(f"kvstore {name!r}: the distributed kvstore is not "
                         "ported to mxnet_tpu_torch yet (ROADMAP E1)")
    if name == "tpu":
        raise MXNetError("kvstore 'tpu': the port's devices are gpu(i); "
                         "use 'device' (multi-GPU is ROADMAP D1)")
    raise MXNetError(f"unknown kvstore type {name!r}")
