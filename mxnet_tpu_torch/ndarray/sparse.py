"""Sparse NDArrays: row_sparse and CSR, O(nnz) on the arrays' device.

PyTorch counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
include/mxnet/ndarray.h:58-62 kRowSparseStorage / kCSRStorage).  What
the sparse storage types are for, in both packages:

* **row_sparse gradients of embeddings**: values (touched rows, d) and
  their row ids, made by :func:`mxnet_tpu_torch.autograd.backward`
  without building the dense (vocab, d) gradient, and consumed by the
  lazy SGD / Adam updates of :mod:`mxnet_tpu_torch.optimizer`, which
  change only those rows (reference: src/operator/optimizer_op.cc);
* **CSR x dense** products by a gather and ``index_add_``, O(nnz * k)
  (reference: src/operator/tensor/dot-inl.h DotCsrDnsDns).

A sparse array's values, indices and indptr live on its device.  Its
dense value is built only when a dense-only code path reads ``_data``
(every op of the registry does), and each such build adds 1 to
:data:`DENSIFY_COUNT`, so tests can hold a sparse path to none.  The
JAX package runs no Pallas kernel here (``_csr_dot`` and
``_dedup_rows_jit``, JAX ``sparse.py:187-219``, are plain ``jnp``), so
plain torch ops (``sort``, ``cumsum``, ``index_add_``,
``index_select``) are the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, as_device, cpu, gpu
from .ndarray import NDArray, numpy_dtype, torch_dtype

# one more every time a sparse array builds its dense value: tests hold
# it flat over the sparse paths
DENSIFY_COUNT = 0


def _mark_densified():
    global DENSIFY_COUNT
    DENSIFY_COUNT += 1


def _tensor(x, dtype=None, device=None):
    """An NDArray, tensor, numpy array or list as a tensor: an array on
    its own device unless ``device`` is given, a host value on
    ``device`` (default: the current context)."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        arr = np.asarray(x)
        if dtype is None and arr.dtype == np.float64:
            dtype = np.float32
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device is None:
            device = as_device(None)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t if device is None else t.to(device)


def _index(x, device):
    """Row or column ids as int64 on ``device`` (float ids truncate)."""
    return _tensor(x, device=device).to(torch.int64)


class BaseSparseNDArray(NDArray):
    """An NDArray whose dense value (``_data``) is built at its first
    read, counted in :data:`DENSIFY_COUNT`; shape, dtype and context
    come from the sparse parts without building it."""
    __slots__ = ("_sp_data", "_sp_indices", "_sp_shape", "_dense")

    def _arm(self, data, indices, shape, dtype, ctx):
        if shape is None:
            raise MXNetError(f"{type(self).__name__}: shape is required")
        dev = None if ctx is None else as_device(ctx)
        values = _tensor(data, dtype, dev)
        self._sp_data = NDArray(values)
        self._sp_indices = NDArray(_index(indices, values.device))
        self._sp_shape = tuple(int(s) for s in shape)
        self._dense = None
        self._grad = None
        self._grad_req = "null"

    @property
    def _data(self):
        if self._dense is None:
            _mark_densified()
            self._dense = self._densify()
        return self._dense

    @_data.setter
    def _data(self, value):
        self._dense = value

    def _densify(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def shape(self):
        return self._sp_shape

    @property
    def size(self):
        return int(np.prod(self._sp_shape))

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def dtype(self):
        return numpy_dtype(self._sp_data._data.dtype)

    @property
    def context(self) -> Context:
        dev = self._sp_data._data.device
        return gpu(dev.index or 0) if dev.type == "cuda" else cpu()

    ctx = context

    @property
    def data(self) -> NDArray:
        return self._sp_data

    @property
    def indices(self) -> NDArray:
        return self._sp_indices

    def todense(self) -> NDArray:
        return NDArray(self._data)

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"cast {self.stype} -> {stype} unsupported")

    def as_in_context(self, context: Context):
        if context == self.context:
            return self
        return self._moved(context.torch_device())

    def copyto(self, other):
        if isinstance(other, Context):
            return self._moved(other.torch_device())
        return super().copyto(other)

    def _moved(self, device):
        raise NotImplementedError


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` of a ``shape`` array hold ``data`` (nnz_rows,
    *shape[1:]); every other row is 0 (reference: ndarray.h
    kRowSparseStorage).  Repeated row ids add up, as in the JAX
    package's densify."""
    __slots__ = ()

    def __init__(self, data, indices, shape, dtype=None, ctx=None):
        self._arm(data, indices, shape, dtype, ctx)

    @property
    def stype(self):
        return "row_sparse"

    def _densify(self):
        v = self._sp_data._data
        return torch.zeros(self._sp_shape, dtype=v.dtype,
                           device=v.device).index_add_(
                               0, self._sp_indices._data, v)

    def _moved(self, device):
        return RowSparseNDArray(self._sp_data._data.to(device),
                                self._sp_indices._data.to(device),
                                self._sp_shape)

    def retain(self, row_ids):
        """The stored rows whose ids are in ``row_ids`` (reference:
        sparse_retain op)."""
        idx = self._sp_indices._data
        keep = torch.isin(idx, _index(row_ids, idx.device))
        return RowSparseNDArray(self._sp_data._data[keep], idx[keep],
                                self._sp_shape)

    def __repr__(self):
        return (f"\n<RowSparseNDArray {self._sp_shape} "
                f"nnz_rows={self._sp_indices.shape[0]} @{self.context}>")


class CSRNDArray(BaseSparseNDArray):
    """A 2-D array in compressed sparse rows: row r holds ``data`` at
    columns ``indices`` over ``indptr[r]:indptr[r + 1]`` (reference:
    ndarray.h kCSRStorage).  ``dot`` with a dense array is O(nnz * k)."""
    __slots__ = ("_sp_indptr", "_sp_rows")

    def __init__(self, data, indices, indptr, shape, dtype=None, ctx=None):
        self._arm(data, indices, shape, dtype, ctx)
        self._sp_indptr = NDArray(_index(indptr, self._sp_data._data.device))
        self._sp_rows = None

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return self._sp_indptr

    def _rows(self) -> torch.Tensor:
        """The row id of every nonzero, made on the device once
        (``output_size`` keeps the card from waiting on a readback)."""
        if self._sp_rows is None:
            iptr = self._sp_indptr._data
            self._sp_rows = torch.repeat_interleave(
                torch.arange(self._sp_shape[0], device=iptr.device),
                iptr[1:] - iptr[:-1],
                output_size=self._sp_data._data.shape[0])
        return self._sp_rows

    def _densify(self):
        v = self._sp_data._data
        return torch.zeros(self._sp_shape, dtype=v.dtype,
                           device=v.device).index_put_(
                               (self._rows(), self._sp_indices._data), v,
                               accumulate=True)

    def _moved(self, device):
        return CSRNDArray(self._sp_data._data.to(device),
                          self._sp_indices._data.to(device),
                          self._sp_indptr._data.to(device), self._sp_shape)

    def dot(self, dense) -> NDArray:
        """CSR x dense -> dense, by a gather of ``dense``'s rows at the
        column ids and an ``index_add_`` into the row ids, O(nnz * k)
        (reference: tensor/dot-inl.h DotCsrDnsDns).  The sum order of a
        row's terms is the card's (``index_add_``'s atomics there)."""
        d = _tensor(dense, device=self._sp_data._data.device)
        return NDArray(_csr_dot(self._sp_data._data, self._rows(),
                                self._sp_indices._data, d,
                                self._sp_shape[0]))

    def __repr__(self):
        return (f"\n<CSRNDArray {self._sp_shape} "
                f"nnz={self._sp_data.shape[0]} @{self.context}>")


def _csr_dot(data, rows, cols, dense, n_rows):
    contrib = data[:, None] * dense.index_select(0, cols)
    return torch.zeros((n_rows, dense.shape[1]), dtype=contrib.dtype,
                       device=contrib.device).index_add_(0, rows, contrib)


def dedup_rows(values, indices, oob_index):
    """Sum the values of repeated row ids, with static shapes and no wait
    on the card (reference: indexing_op.h AddTakeGradRspKernel's
    sort-and-accumulate).

    Returns ``(agg_values, dedup_indices)`` of the input's length: the
    unique ids in ascending order, each with its values summed (in the
    input's order, as a stable sort keeps them) in its slot, and the
    slots left over holding ``oob_index`` with zero values."""
    order = torch.argsort(indices, stable=True)
    sidx = indices[order]
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[1:] = sidx[1:] != sidx[:-1]
    slot = torch.cumsum(first, 0) - 1
    agg = torch.zeros_like(values).index_add_(0, slot, values[order])
    out_idx = torch.full_like(indices, oob_index)
    out_idx[slot] = sidx
    return agg, out_idx


def row_sparse_array(arg1, shape=None, dtype=None, ctx=None):
    """A RowSparseNDArray from ``(data, indices)`` with ``shape``, or from
    a dense array (its rows that are not all 0)."""
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, dtype=dtype, ctx=ctx)
    dense = _tensor(arg1, dtype, None if ctx is None else as_device(ctx))
    nz = torch.nonzero(dense.reshape(dense.shape[0], -1).ne(0).any(1))
    nz = nz.reshape(-1)
    return RowSparseNDArray(dense.index_select(0, nz), nz, dense.shape)


def csr_matrix(arg1, shape=None, dtype=None, ctx=None):
    """A CSRNDArray from ``(data, indices, indptr)`` with ``shape``, or
    from a dense 2-D array (its nonzeros in row order)."""
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indices, indptr, shape, dtype=dtype, ctx=ctx)
    dense = _tensor(arg1, dtype, None if ctx is None else as_device(ctx))
    if dense.dim() != 2:
        raise MXNetError("csr requires a 2-D array")
    rows, cols = torch.nonzero(dense, as_tuple=True)
    indptr = torch.searchsorted(
        rows, torch.arange(dense.shape[0] + 1, device=dense.device))
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None, rng=None,
                        ctx=None):
    """A random sparse array and its dense numpy twin, drawn as the JAX
    package draws them (reference: test_utils.py:254): ``density``
    picks rows for row_sparse and elements for csr."""
    rng = rng or np.random
    density = 0.2 if density is None else density
    dtype = np.dtype(dtype or np.float32)
    if stype == "row_sparse":
        row_mask = rng.uniform(0, 1, shape[0]) < density
        dense = (rng.uniform(-1, 1, shape) *
                 row_mask.reshape((-1,) + (1,) * (len(shape) - 1))
                 ).astype(dtype)
        return row_sparse_array(dense, ctx=ctx), dense
    dense = (rng.uniform(-1, 1, shape) *
             (rng.uniform(0, 1, shape) < density)).astype(dtype)
    if stype == "csr":
        if len(shape) != 2:
            raise MXNetError("csr requires 2-D shape")
        return csr_matrix(dense, ctx=ctx), dense
    raise MXNetError(f"unknown sparse stype {stype!r}")


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` (reference: tensor/cast_storage-inl.h):
    a dense array's nonzero rows or elements found on its device; a
    sparse array to another type goes through its (counted) dense
    value."""
    if stype == getattr(arr, "stype", "default"):
        return arr
    if stype == "default":
        return NDArray(arr._data)
    if stype == "row_sparse":
        return row_sparse_array(NDArray(arr._data))
    if stype == "csr":
        return csr_matrix(NDArray(arr._data))
    raise MXNetError(f"unknown storage type {stype!r}")


def square_sum(arr, axis=None, keepdims=False):
    """Sum of squares over a RowSparseNDArray's stored rows alone, O(nnz)
    (reference: tensor/square_sum-inl.h ``_square_sum`` on
    kRowSparseStorage): axis None or 0 gives a dense NDArray, axis 1 a
    RowSparseNDArray with the input's row ids.  A dense input goes to
    the registered ``_square_sum`` op."""
    if not isinstance(arr, RowSparseNDArray):
        from .ndarray import _invoke
        return _invoke("_square_sum", [arr],
                       {"axis": axis, "keepdims": keepdims})
    vals = arr.data._data
    if isinstance(axis, (tuple, list)):
        axis = axis[0] if len(axis) == 1 else None
    if axis is None:
        return NDArray(torch.sum(vals.square()))
    if len(arr.shape) != 2:
        raise MXNetError(
            "square_sum with an axis supports 2-D row_sparse only "
            f"(got shape {arr.shape}); use axis=None or densify")
    axis = axis % 2
    if axis == 0:
        out = torch.sum(vals.square(), dim=0)
        return NDArray(out[None] if keepdims else out)
    row = torch.sum(vals.reshape(vals.shape[0], -1).square(), dim=1)
    shape = (arr.shape[0], 1) if keepdims else (arr.shape[0],)
    return RowSparseNDArray(row[:, None] if keepdims else row,
                            arr.indices, shape)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero sparse array with nothing stored, on ``ctx``."""
    dev = as_device(ctx)
    dt = torch_dtype(dtype or np.float32)
    shape = tuple(shape)
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev), empty,
            shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev), empty,
                          torch.zeros(shape[0] + 1, dtype=torch.int64,
                                      device=dev), shape)
    raise MXNetError(f"unknown sparse stype {stype!r}")
