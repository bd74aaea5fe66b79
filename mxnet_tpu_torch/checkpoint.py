"""Sharded and asynchronous checkpoints.

PyTorch counterpart of ``mxnet_tpu/checkpoint.py``, with the same files,
so a checkpoint written by either package loads in the other.  A save
writes ``<prefix>.shard<rank>`` (magic ``MXTPUSH1``, uint64 header
length, a JSON header of {name, index, dtype, offset, nbytes} blocks,
then the raw bytes) and ``<prefix>.index`` ({"nprocs", "params": {name:
{shape, dtype}}}), each through a temporary file and a rename, the index
last.  dtype names are numpy's (``float32``); ``bfloat16``, which numpy
lacks, is stored as raw 16-bit words and read back as
``torch.bfloat16`` (no ``ml_dtypes`` needed).

Reference behaviour (SURVEY.md §5.4): ``mx.model.save_checkpoint``
writes ``prefix-symbol.json`` + ``prefix-%04d.params``; ``fit(...,
begin_epoch=N)`` resumes; optimizer states ride
``Module.save_optimizer_states``.

This process is rank 0 of 1: it writes every array whole, as one block.
The multi-rank side of the JAX package (the barrier, the shard
rendezvous across processes and the nonce broadcast,
``mxnet_tpu/checkpoint.py:137-145,238-241``) comes with multi-GPU
(ROADMAP D1): where a ``torch.distributed`` group of more than one rank
is initialized, the savers raise.

:class:`AsyncCheckpointer` overlaps the write with training.  Its
snapshot copies every parameter on the device, on the caller's current
stream (the port's optimizers rebind the weights they update, but a
tensor may be written in place, by a user's torch code or through
``contrib.torch``, which hands tensors over without a copy, so no
reference to a live tensor may be kept), records an event after the
copies, and enqueues on a stream of its own, behind that event, the
copies into one pinned host buffer that the checkpointer keeps and
reuses (pinning a fresh buffer every save costs tens to hundreds of ms
of host time; the first save pays it once), then returns.  A writer
thread waits for that stream, drops the device copies and writes the
shard file: it makes no launch, so it does not compete for the
interpreter lock with a training loop bound by its host.  So the
training stream never waits for the device-to-host copy, and a save in
flight holds one extra copy of the parameters on the device until the
copy to the host lands.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import uuid
from typing import Dict

import numpy as np
import torch

from .base import MXNetError, env
from .ndarray import NDArray

_MAGIC = b"MXTPUSH1"


def _rank_count():
    """(rank, count) of the processes that write one checkpoint: (0, 1).
    A ``torch.distributed`` group of more than one rank needs the
    multi-rank protocol, which is not here yet."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise MXNetError(
            "checkpoint: a process group of %d ranks is initialized; "
            "multi-rank checkpoints (the barrier, the shard rendezvous "
            "and the nonce broadcast) come with multi-GPU (ROADMAP D1)"
            % dist.get_world_size())
    return 0, 1


def _dtype_name(v) -> str:
    """numpy's name of a tensor's or array's dtype (``bfloat16`` for
    torch.bfloat16)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=v.dtype).numpy().dtype)
    return str(np.asarray(v).dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if "bfloat16" in name:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _host_bytes(v) -> memoryview:
    """The raw bytes of a host tensor or array, without a copy where it
    is contiguous."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        return memoryview(t.view(-1).view(torch.uint8).numpy()) \
            if t.numel() else memoryview(b"")
    return memoryview(np.ascontiguousarray(v).tobytes())


def _write_local_shard(prefix: str, params: Dict, token=None) -> Dict:
    """Write this process's shard file (temporary file, then rename) and
    return the index's ``params`` entry.  ``params`` maps names to host
    tensors, arrays or NDArrays.  ``token`` (asynchronous saves) rides
    the shard header, so the rendezvous tells this save's shard from a
    stale one at the same path."""
    rank, _ = _rank_count()
    entries, bufs, index = [], [], {}
    offset = 0
    for name, arr in params.items():
        v = arr._data if isinstance(arr, NDArray) else arr
        dt = _dtype_name(v)
        shape = list(v.shape)
        index[name] = {"shape": shape, "dtype": dt}
        raw = _host_bytes(v)
        entries.append({"name": name, "index": [[0, s] for s in shape],
                        "dtype": dt, "offset": offset, "nbytes": raw.nbytes})
        bufs.append(raw)
        offset += raw.nbytes
    # a tokenless (synchronous) save keeps the bare entry list: the
    # on-disk format of the golden files; asynchronous saves wrap it
    header = entries if token is None else {"token": token,
                                            "entries": entries}
    hjson = json.dumps(header).encode()
    shard_path = f"{prefix}.shard{rank}"
    with open(shard_path + ".tmp", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in bufs:
            f.write(raw)
    os.replace(shard_path + ".tmp", shard_path)
    return index


def _read_shard_header(path):
    """(header entries, token, data offset) of a shard file."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise MXNetError(f"{path}: bad shard magic")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
    if isinstance(header, dict):
        return header["entries"], header.get("token"), 16 + hlen
    return header, None, 16 + hlen


def _write_index(prefix: str, index: Dict, token=None) -> None:
    _, count = _rank_count()
    doc = {"nprocs": count, "params": index}
    if token is not None:
        doc["token"] = token
    with open(f"{prefix}.index.tmp", "w") as f:
        json.dump(doc, f)
    os.replace(f"{prefix}.index.tmp", f"{prefix}.index")


def save_params_sharded(prefix: str, params: Dict[str, NDArray]) -> None:
    """Write the shard and then the index: a kill in the middle never
    leaves a readable-looking broken checkpoint."""
    _write_index(prefix, _write_local_shard(prefix, params))


def load_params_sharded(prefix: str) -> Dict[str, NDArray]:
    """The arrays of a sharded checkpoint, assembled from every shard
    file, as NDArrays on the CPU."""
    with open(f"{prefix}.index") as f:
        index = json.load(f)
    out = {}
    for r in range(index["nprocs"]):
        path = f"{prefix}.shard{r}"
        if not os.path.exists(path):
            raise MXNetError(f"missing checkpoint shard file {path}")
        header, _tok, data_off = _read_shard_header(path)
        with open(path, "rb") as f:
            f.seek(data_off)
            blob = f.read()
        for ent in header:
            shape = [b - a for a, b in ent["index"]]
            dt = _torch_dtype(ent["dtype"])
            raw = np.frombuffer(blob, np.uint8, count=ent["nbytes"],
                                offset=ent["offset"])
            block = torch.from_numpy(raw.copy()).view(dt).reshape(shape)
            meta = index["params"][ent["name"]]
            if shape == list(meta["shape"]):   # the whole array
                out[ent["name"]] = block
                continue
            if ent["name"] not in out:
                out[ent["name"]] = torch.zeros(
                    meta["shape"], dtype=_torch_dtype(meta["dtype"]))
            sl = tuple(slice(a, b) for a, b in ent["index"])
            out[ent["name"]][sl] = block
    for name, meta in index["params"].items():
        if name not in out:     # a shape with no element has no block
            out[name] = torch.zeros(meta["shape"],
                                    dtype=_torch_dtype(meta["dtype"]))
    return {name: NDArray(out[name]) for name in index["params"]}


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (the orbax async-save
    pattern; the reference's snapshots were synchronous).

    ``save_params`` snapshots every value on its device and returns; a
    background thread copies the snapshot to the host and writes the
    shard file, then the index (the module docstring says how the
    copies are ordered against training).

    One save is in flight at a time: a new ``save_params`` (or
    ``wait``) joins the previous write first and re-raises its failure.
    ``wait()`` returns once the index is on disk, so ``wait()`` then
    :func:`load_params_sharded` is safe.

    Each save carries the token ``<run nonce>:<seq>`` in its shard
    header and index (the nonce a uuid drawn once a checkpointer, seq a
    counter a prefix), so the rendezvous never indexes a shard of
    another save left at the same path.  ``MXNET_CKPT_RENDEZVOUS_TIMEOUT``
    bounds the rendezvous, as in the JAX package.  Saving to the same
    prefix again overwrites it in place.
    """

    def __init__(self, poll_interval_s: float = 0.1,
                 timeout_s: float = None):
        self._poll = poll_interval_s
        self._timeout = float(env("MXNET_CKPT_RENDEZVOUS_TIMEOUT", 600.0)
                              if timeout_s is None else timeout_s)
        self._thread = None
        self._err = None
        self._nonce = None
        self._seq = {}      # prefix -> saves issued
        self._pinned = None  # the reused pinned host buffer (uint8)
        self._streams = {}  # device -> the writer's stream
        # one dict a save: the caller's ms in save_params (main_ms, the
        # wait for the previous save apart: wait_ms), the snapshot's
        # bytes, and from the writer the device-to-host copy and the
        # file write in seconds (d2h_s, write_s)
        self.saves = []

    def _run_nonce(self):
        if self._nonce is None:
            self._nonce = uuid.uuid4().bytes.hex()
        return self._nonce

    def _stream(self, device):
        st = self._streams.get(device)
        if st is None:
            st = self._streams[device] = torch.cuda.Stream(device)
        return st

    def _snapshot(self, params):
        """(snapshot, done event, device copies).  Host values are copied
        on the host.  Device tensors are copied on the device, on the
        caller's current stream; an event recorded after the copies
        orders the writer's stream behind them, on which each copy is
        copied on into a view of the pinned buffer (``non_blocking``),
        all enqueued here, so that the writer thread has no Python
        launches to make (it would contend for the interpreter lock with
        a training loop that is bound by its host).  The device copies
        are marked for the writer's stream and must live until ``done``;
        the snapshot holds the pinned views."""
        snap, device = {}, None
        for name, arr in params.items():
            v = arr._data if isinstance(arr, NDArray) else arr
            if isinstance(v, torch.Tensor):
                snap[name] = v.detach().clone()
                if v.is_cuda:
                    device = v.device
            else:
                snap[name] = np.array(v, copy=True)
        if device is None:
            return snap, None, []
        stream = self._stream(device)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        cuda = [(n, t) for n, t in snap.items()
                if isinstance(t, torch.Tensor) and t.is_cuda]
        total = sum(t.numel() * t.element_size() for _, t in cuda)
        if self._pinned is None or self._pinned.numel() < total:
            self._pinned = None
            self._pinned = torch.empty(total, dtype=torch.uint8,
                                       pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            off = 0
            for name, t in cuda:
                t.record_stream(stream)
                nbytes = t.numel() * t.element_size()
                host = self._pinned[off:off + nbytes].view(t.dtype) \
                    .view(t.shape)
                host.copy_(t, non_blocking=True)
                snap[name] = host
                off += nbytes
            done = torch.cuda.Event()
            done.record(stream)
        return snap, done, [t for _, t in cuda]

    @staticmethod
    def _fresh(path, token):
        """True when ``path`` is this save's shard (full-token match)."""
        try:
            _ents, tok, _off = _read_shard_header(path)
            return tok == token
        except (OSError, MXNetError, ValueError, KeyError):
            return False  # mid-rename or partial: keep polling

    def save_params(self, prefix: str, params: Dict[str, NDArray]) -> None:
        """Snapshot ``params`` and write them in the background."""
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        _, count = _rank_count()
        self._seq[prefix] = self._seq.get(prefix, -1) + 1
        token = f"{self._run_nonce()}:{self._seq[prefix]}"
        snap, done, copies = self._snapshot(params)
        rec = {"prefix": prefix, "wait_ms": (t1 - t0) * 1e3,
               "bytes": sum(t.numel() * t.element_size()
                            for t in snap.values()
                            if isinstance(t, torch.Tensor))}
        self.saves.append(rec)

        def _write():
            try:
                w0 = time.perf_counter()
                if done is not None:
                    done.synchronize()
                    copies.clear()
                w1 = time.perf_counter()
                index = _write_local_shard(prefix, snap, token=token)
                rec.update(d2h_s=w1 - w0,
                           write_s=time.perf_counter() - w1)
                snap.clear()
                deadline = time.monotonic() + self._timeout
                missing = set(range(count))
                while missing:
                    missing = {r for r in missing if not self._fresh(
                        f"{prefix}.shard{r}", token)}
                    if not missing:
                        break
                    if time.monotonic() > deadline:
                        raise MXNetError(
                            f"async checkpoint {prefix}: the shards of "
                            f"rank(s) {sorted(missing)} are missing after "
                            f"{self._timeout:.0f}s; raise "
                            "MXNET_CKPT_RENDEZVOUS_TIMEOUT if the file "
                            "system is just slow")
                    time.sleep(self._poll)
                _write_index(prefix, index, token=token)
            except BaseException as e:  # noqa: BLE001 — raised at wait()
                self._err = e
            finally:
                snap.clear()
                copies.clear()

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="mxnet-ckpt-writer")
        self._thread.start()
        rec["main_ms"] = (time.perf_counter() - t1) * 1e3

    def save_checkpoint(self, prefix: str, epoch: int, symbol, arg_params,
                        aux_params) -> None:
        """The asynchronous :func:`save_checkpoint_sharded`."""
        path = _checkpoint_prelude(prefix, epoch, symbol)
        self.save_params(path, _merge_arg_aux(arg_params, aux_params))

    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self, timeout: float = None) -> None:
        """Join the save in flight and re-raise its failure; with
        ``timeout``, raise if it has not ended by then."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise MXNetError(f"async checkpoint: the write did not end "
                                 f"within {timeout} s")
        self._thread = None
        err, self._err = self._err, None
        if err is not None:
            raise err


def _merge_arg_aux(arg_params, aux_params):
    """One dict of parameters with the ``aux:`` names of
    :func:`load_checkpoint_sharded`."""
    merged = dict(arg_params)
    merged.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    return merged


def _checkpoint_prelude(prefix, epoch, symbol):
    """The symbol file and the epoch's parameter path, shared by the
    synchronous and the asynchronous saver."""
    _rank_count()
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    return f"{prefix}-{epoch:04d}.params"


def save_checkpoint_sharded(prefix: str, epoch: int, symbol, arg_params,
                            aux_params) -> None:
    """Sharded ``model.save_checkpoint`` (reference: model.py:94)."""
    path = _checkpoint_prelude(prefix, epoch, symbol)
    save_params_sharded(path, _merge_arg_aux(arg_params, aux_params))


def load_serving_params(prefix: str, epoch: int):
    """``(symbol, arg_params, aux_params)`` of either flavour at
    ``prefix-%04d.params``: the single file of ``model.save_checkpoint``
    or the sharded one (:func:`save_checkpoint_sharded`,
    :class:`AsyncCheckpointer`; told by its ``.index`` file)."""
    path = f"{prefix}-{epoch:04d}.params"
    if os.path.exists(path + ".index"):
        return load_checkpoint_sharded(prefix, epoch)
    from .model import load_checkpoint
    return load_checkpoint(prefix, epoch)


def load_checkpoint_sharded(prefix: str, epoch: int):
    """Sharded ``model.load_checkpoint`` (reference: model.py:105)."""
    from .symbol.symbol import load as sym_load
    sym = None
    if os.path.exists(f"{prefix}-symbol.json"):
        sym = sym_load(f"{prefix}-symbol.json")
    loaded = load_params_sharded(f"{prefix}-{epoch:04d}.params")
    arg_params = {k: v for k, v in loaded.items()
                  if not k.startswith("aux:")}
    aux_params = {k[4:]: v for k, v in loaded.items()
                  if k.startswith("aux:")}
    return sym, arg_params, aux_params
