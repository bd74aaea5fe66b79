"""Bucketed predict dispatch with hot weight swap.

PyTorch counterpart of ``mxnet_tpu/serving/bucketed.py``.  A batch of n
requests pads to the smallest configured bucket that covers it
(``MXNET_SERVING_BUCKETS``) and the padded rows are sliced off before the
reply; a batch larger than the largest bucket is chunked through it.
PyTorch runs eagerly, so a bucket costs no compile, but the padded
shapes still bound the set of kernel shapes the card sees, and the
``serving.predict_compile`` counter still marks each bucket's first
dispatch.

Weight refresh is a data swap: :meth:`BucketedPredictor.set_params`
replaces the served tensors under a lock and every later predict serves
the new version.

Reply slicing keeps whole examples: an output whose leading dim is
``k * bucket`` (the LM's flattened (B*S, vocab) softmax) keeps its first
``k * n`` rows.  The JAX package slices every output to its first n rows,
which is right only for k = 1.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError, env
from ..context import as_device
from ..executor import build_interpreter, graph_generator
from .. import profiler as _prof


def parse_buckets(spec=None) -> List[int]:
    """Canonical bucket list from a spec string/iterable (default: the
    ``MXNET_SERVING_BUCKETS`` knob): sorted, deduped, all positive."""
    if spec is None:
        spec = env("MXNET_SERVING_BUCKETS", "1,2,4,8,16,32")
    if isinstance(spec, str):
        items = [s for s in spec.replace(" ", "").split(",") if s]
    else:
        items = list(spec)
    try:
        buckets = sorted({int(b) for b in items})
    except (TypeError, ValueError):
        raise MXNetError(f"bad serving bucket spec {spec!r}: expected "
                         "comma-separated positive batch sizes")
    if not buckets or buckets[0] < 1:
        raise MXNetError(f"bad serving bucket spec {spec!r}: buckets "
                         "must be >= 1")
    return buckets


def rows_per_example(out_rows: int, n: int) -> int:
    """How many leading rows of an output belong to one example of an
    n-example batch (1 for per-example outputs, S for the LM's flattened
    per-token softmax)."""
    if n < 1 or out_rows % n:
        raise MXNetError(f"output with {out_rows} leading rows does not "
                         f"split into {n} examples")
    return out_rows // n


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


class BucketedPredictor:
    """Weights on the device -> bucketed predict dispatches with hot
    weight swap.

    ``data_shapes`` maps each data input name to its per-example FEATURE
    shape (no batch dim); every other symbol input that is not a
    parameter (labels a loss head declares) is fed cached zeros.  ``ctx``
    (a Context, torch.device or device string) defaults to ``gpu(0)``,
    which raises when CUDA is absent.  ``compute_dtype`` is None (float32)
    or ``"bfloat16"``.
    """

    def __init__(self, symbol, data_shapes: Dict[str, tuple], arg_params,
                 aux_params=None, buckets=None, compute_dtype=None,
                 data_dtypes: Optional[Dict[str, object]] = None, ctx=None):
        self.device = as_device(ctx)
        self._sym = symbol
        self._run, self._arg_names, self._aux_names = build_interpreter(
            symbol, compute_dtype)
        # a graph that draws (Dropout with mode="always") draws from its
        # own stream, seeded from the package's generator as an
        # Executor's is
        self._gen = graph_generator(self._run, self.device)
        self._data_shapes = {n: tuple(int(d) for d in s)
                             for n, s in dict(data_shapes).items()}
        unknown = [n for n in self._data_shapes
                   if n not in self._arg_names]
        if unknown:
            raise MXNetError(f"data_shapes name(s) {unknown} are not "
                             f"inputs of the symbol ({self._arg_names})")
        self._data_names = [n for n in self._arg_names
                            if n in self._data_shapes]
        self._data_dtypes = {
            n: np.dtype((data_dtypes or {}).get(n, np.float32))
            for n in self._data_names}
        self._param_names = [n for n in self._arg_names
                             if n not in self._data_shapes
                             and n in dict(arg_params)]
        self._extra_inputs = [n for n in self._arg_names
                              if n not in self._data_shapes
                              and n not in self._param_names]
        self.buckets = parse_buckets(buckets)
        self._lock = threading.Lock()
        self._params: Dict[str, torch.Tensor] = {}
        self._aux: Dict[str, torch.Tensor] = {}
        self.version = 0
        self._bucket_inputs: Dict[int, Dict[str, torch.Tensor]] = {}
        self._compiled = set()   # buckets dispatched at least once
        self.set_params(arg_params, aux_params, version=0)

    # -- weights -------------------------------------------------------------
    def _as_tensor(self, v) -> torch.Tensor:
        v = _raw(v)
        if isinstance(v, torch.Tensor):
            return v.detach().to(self.device)
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

    def set_params(self, arg_params, aux_params=None, version=None):
        """Swap the served weights.  Values (numpy arrays or tensors) are
        cast to the incumbent dtype; a changed shape raises — a refresh
        can change numbers, never the model's architecture."""
        arg_params = dict(arg_params)
        missing = [n for n in self._param_names if n not in arg_params]
        if missing:
            raise MXNetError(f"set_params: missing parameter(s) {missing}")
        new_p, new_a = {}, {}
        for name in self._param_names:
            v = self._as_tensor(arg_params[name])
            old = self._params.get(name)
            if old is not None:
                if tuple(v.shape) != tuple(old.shape):
                    raise MXNetError(
                        f"set_params: shape of {name!r} changed "
                        f"{tuple(old.shape)} -> {tuple(v.shape)} — a "
                        "weight refresh cannot re-architect the model")
                if v.dtype != old.dtype:
                    v = v.to(old.dtype)
            new_p[name] = v
        for name in self._aux_names:
            src = (aux_params or {}).get(name)
            if src is None:
                src = self._aux.get(name)
            if src is None:
                raise MXNetError(f"set_params: missing aux state {name!r}")
            v = self._as_tensor(src)
            old = self._aux.get(name)
            if old is not None and v.dtype != old.dtype:
                v = v.to(old.dtype)
            new_a[name] = v
        with self._lock:
            self._params = new_p
            self._aux = new_a
            self.version = int(self.version + 1 if version is None
                               else version)

    def param_specs(self) -> Dict[str, tuple]:
        """{name: (shape, dtype name)} of the served parameters: what a
        weight-refresh pull needs to allocate its out arrays (``bfloat16``
        by name, as the JAX package's ``str(dtype)`` gives it)."""
        with self._lock:
            return {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for n, v in self._params.items()}

    def current_params(self) -> Dict[str, torch.Tensor]:
        """Snapshot of the served parameter values (for a partial
        refresh to merge fresh pulls over)."""
        with self._lock:
            return dict(self._params)

    # -- buckets -------------------------------------------------------------
    def select_bucket(self, n: int) -> int:
        """Smallest bucket covering ``n`` rows (the largest bucket for
        oversized batches — the caller chunks)."""
        if n < 1:
            raise MXNetError(f"select_bucket: need >= 1 row, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _bucket_extra_inputs(self, bucket: int) -> Dict[str, torch.Tensor]:
        """Cached zero tensors for the non-data, non-param inputs at this
        bucket's batch size (ignored in eval mode)."""
        cached = self._bucket_inputs.get(bucket)
        if cached is not None:
            return cached
        shapes = {n: (bucket,) + s for n, s in self._data_shapes.items()}
        arg_shapes, _out, _aux = self._sym.infer_shape(**shapes)
        by_name = dict(zip(self._arg_names, arg_shapes))
        extras = {n: torch.zeros(tuple(by_name[n]), dtype=torch.float32,
                                 device=self.device)
                  for n in self._extra_inputs}
        self._bucket_inputs[bucket] = extras
        return extras

    # -- predict -------------------------------------------------------------
    def predict(self, data: Dict[str, np.ndarray]):
        """Run one padded-bucket forward per <= max(buckets)-row chunk;
        returns ``(version, [numpy outputs for the true rows])``.

        ``data`` maps every data input name to an (n, *feature) array;
        padding rows never reach the reply."""
        datas = {}
        n = None
        for name in self._data_names:
            if name not in data:
                raise MXNetError(f"predict: missing data input {name!r}")
            arr = np.asarray(data[name])
            want = self._data_shapes[name]
            if tuple(arr.shape[1:]) != want:
                raise MXNetError(
                    f"predict: {name!r} feature shape {tuple(arr.shape[1:])}"
                    f" != served shape {want}")
            if n is None:
                n = int(arr.shape[0])
            elif int(arr.shape[0]) != n:
                raise MXNetError("predict: data inputs disagree on the "
                                 "row count")
            datas[name] = np.ascontiguousarray(
                arr, dtype=self._data_dtypes[name])
        if n is None or n < 1:
            raise MXNetError("predict: empty request")
        chunks = []
        version = None
        max_b = self.buckets[-1]
        for lo in range(0, n, max_b):
            hi = min(n, lo + max_b)
            v, outs = self._predict_chunk(
                {name: arr[lo:hi] for name, arr in datas.items()}, hi - lo)
            version = v if version is None else version
            chunks.append(outs)
        if len(chunks) == 1:
            return version, chunks[0]
        return version, [np.concatenate(parts, axis=0)
                         for parts in zip(*chunks)]

    def _predict_chunk(self, datas, n):
        version, outs = self.forward_chunk(datas, n)
        # the reply crosses to the host: the serving loop's one
        # deliberate device sync
        host = [_to_numpy(o) for o in outs]
        _prof.record_host_sync("serving.predict_readback")
        return version, host

    def forward_chunk(self, datas, n):
        """The device half of one chunk: pad ``n`` rows to their bucket,
        run the graph, slice the padding off.  Returns ``(version,
        [device tensors])``; nothing is read back."""
        bucket = self.select_bucket(n)
        pad = bucket - n
        with self._lock:
            params = self._params
            aux = self._aux
            version = self.version
        extras = self._bucket_extra_inputs(bucket)
        arg_vals = []
        for name in self._arg_names:
            if name in datas:
                arr = datas[name]
                if pad:
                    arr = np.concatenate(
                        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)],
                        axis=0)
                arg_vals.append(torch.from_numpy(arr).to(self.device))
            elif name in params:
                arg_vals.append(params[name])
            else:
                arg_vals.append(extras[name])
        aux_vals = tuple(aux[name] for name in self._aux_names)
        if bucket not in self._compiled:
            self._compiled.add(bucket)
            _prof.record_dispatch("serving.predict_compile")
        _prof.record_dispatch("serving.predict")
        with _prof.scope("serving_predict", "symbolic"), \
                torch.inference_mode():
            outs, _ = self._run(tuple(arg_vals), aux_vals, False,
                                self.device, self._gen)
            outs = [o[:n * rows_per_example(o.shape[0], bucket)]
                    for o in outs]
        return version, outs

    def warmup(self):
        """Dispatch every bucket once with a zero batch, so the first
        real request meets built kernels and a warm allocator.  Returns
        the number of buckets run."""
        for b in self.buckets:
            self._predict_chunk(
                {name: np.zeros((b,) + s, self._data_dtypes[name])
                 for name, s in self._data_shapes.items()}, b)
        return len(self.buckets)


def _raw(v):
    """Underlying value of an NDArray (its tensor); anything else as is."""
    data = getattr(v, "_data", None)
    return data if data is not None else v


def _host_array(v) -> np.ndarray:
    """An NDArray, tensor or array-like as a host numpy array (bfloat16,
    which numpy lacks, as float32)."""
    v = _raw(v)
    if isinstance(v, torch.Tensor):
        return _to_numpy(v.detach())
    return np.asarray(v)
