"""Evaluation metrics.

PyTorch counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``,
``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss`` (and its
``Torch`` and ``Caffe`` names), ``CustomMetric`` with ``np`` and
``create``. A metric computes with
torch ops on the device its predictions live on and keeps its running
sums there, so a training step does not read the (B*S, vocab) softmax
back to the host.  Two paths, as in the JAX package:

* ``update`` / ``update_dict`` keep each batch's sum as a pending tensor
  and read every one back at ``get()`` (one readback a batch, counted as
  ``metric.update`` by ``profiler.record_host_sync``);
* the device-resident API (``device_init``, ``device_update``,
  ``update_device``, ``accumulate``, ``accumulate_dict``, ``sync``) folds
  each batch into a float32 sum and an int32 count kept as tensors on
  the predictions' device, and ``sync`` (which ``get()`` calls) reads
  them back at once (``metric.sync``).  ``Module.update_metric``,
  ``run_steps`` and ``gluon.Trainer``'s loops accumulate, so a training
  loop syncs only when a callback reads the metric;
  ``MXNET_DEVICE_METRICS=0`` restores the per-batch path.

Labels and predictions may be NDArrays, tensors or numpy arrays.  Where
the host would have to look at a label to reject it (F1's labels outside
{0, 1}, CrossEntropy's and Perplexity's outside the class axis), the
batch is left out of the sums on the device and the error is raised at
the next ``get()`` (or ``sync``), as the JAX package's device path does.
A ``CustomMetric`` (and ``PearsonCorrelation``) has no device form: it
computes per batch, and ``accumulate`` falls back to ``update`` with a
one-time warning.
"""
from __future__ import annotations

import logging
import math

import numpy  # `np` is the module-level metric factory below
import torch

from .base import MXNetError, env
from .ndarray import NDArray
from . import profiler as _prof

_METRIC_REGISTRY = {}


def _t(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(numpy.ascontiguousarray(numpy.asarray(x)))


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")


def _read_states(states):
    """Device states (tuples of 0-d tensors) as tuples of host numbers,
    read back at once: one float64 vector a device (one for the usual
    single card; the int32 counts are exact in float64)."""
    flat = [t for st in states for t in st]
    by_dev = {}
    for i, t in enumerate(flat):
        by_dev.setdefault(t.device, []).append(i)
    vals = [None] * len(flat)
    _prof.record_host_sync("metric.sync")
    for idx in by_dev.values():
        host = torch.stack([flat[i].to(torch.float64) for i in idx]).tolist()
        for i, v in zip(idx, host):
            vals[i] = v
    out, k = [], 0
    for st in states:
        out.append(tuple(vals[k:k + len(st)]))
        k += len(st)
    return out


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a name, an EvalMetric, a function of (label, pred)
    (a ``CustomMetric``) or a list of them (reference: metric.py
    create)."""
    if callable(metric) and not isinstance(metric, EvalMetric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        try:
            return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            pass
    raise MXNetError(f"unknown metric {metric!r}; registered: "
                     f"{sorted(_METRIC_REGISTRY)}")


class EvalMetric:
    """Base metric (reference: metric.py EvalMetric).  A subclass with a
    device form sets ``device_capable`` and gives each batch's terms by
    :meth:`_terms` (a sum and a count on the predictions' device, and
    the out-of-range label count of a :class:`_DeferredBadLabels`), which
    both paths fold: ``update`` into pending sums that ``get`` reads
    back, ``device_update`` into the (float32 sum, int32 count) state."""

    device_capable = False
    _device_state = None   # class default: subclasses never AttributeError

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        """The metric's constructor arguments, class and names."""
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__,
                       "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def _select_dict(self, label, pred):
        """output_names / label_names selection, shared by the host
        (update_dict) and device (device_update_dict) entry points."""
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        return label, pred

    def update_dict(self, label, pred):
        label, pred = self._select_dict(label, pred)
        self.update(label, pred)

    # -- a batch's terms, shared by both paths --------------------------------
    def _check(self, labels, preds):
        check_label_shapes(labels, preds)

    def _pairs(self, labels, preds):
        return zip(labels, preds)

    def _terms(self, label, pred):
        """(sum, count, out-of-range labels or None) of one batch, on the
        predictions' device, read back by nobody."""
        raise NotImplementedError()

    def update(self, labels, preds):
        self._check(labels, preds)
        for label, pred in self._pairs(labels, preds):
            total, count, nbad = self._terms(label, pred)
            self._accumulate(total, count)
            if nbad is not None:
                self._count_bad(nbad)

    def _accumulate(self, total, count):
        """Add a batch's sum (a 0-d tensor on any device) and count (an
        int or 0-d tensor) without reading them back."""
        self._pending.append((total.double(), count))

    def _sync(self):
        if self._pending:
            s = n = 0
            for t, c in self._pending:
                # the host path's readback of a batch
                _prof.record_host_sync("metric.update")
                s += float(t)
                n += int(c)
            self._pending = []
            self.sum_metric += s
            self.num_inst += n

    # -- device-resident accumulation (JAX package metric.py:109-232) --------
    def device_init(self):
        """A zero (float32 sum, int32 count) state; it moves to the
        predictions' device at the first fold."""
        return (torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.int32))

    def device_update(self, state, labels, preds):
        """Fold one batch of ``labels`` / ``preds`` into ``state`` and
        return the new state, on the predictions' device, with no
        readback: the float32 sum takes each batch's term in float32,
        the int32 count its count."""
        if not self.device_capable:
            raise NotImplementedError(
                f"{type(self).__name__} has no device form")
        self._check(labels, preds)
        s, n, *bad = state
        for label, pred in self._pairs(labels, preds):
            total, count, nbad = self._terms(label, pred)
            dev = total.device
            s = s.to(dev) + total.to(torch.float32)
            n = n.to(dev) + (count.to(device=dev, dtype=torch.int32)
                             if isinstance(count, torch.Tensor)
                             else int(count))
            if bad:
                bad = [bad[0].to(dev) + nbad.to(torch.int32)]
        return (s, n, *bad)

    def device_update_dict(self, state, label, pred):
        """``update_dict`` in functional device form."""
        label, pred = self._select_dict(label, pred)
        return self.device_update(state, label, pred)

    def update_device(self, labels, preds):
        """The stateful device update: nothing crosses to the host until
        :meth:`sync`."""
        self._device_state = self.device_update(
            self._device_state_or_init(), labels, preds)

    def device_enabled(self):
        """The one rule for device-resident accumulation: a device form,
        and ``MXNET_DEVICE_METRICS`` not 0."""
        return self.device_capable and env("MXNET_DEVICE_METRICS", True)

    def accumulate(self, labels, preds):
        """``update`` without the per-batch readback where the metric has
        a device form (and ``MXNET_DEVICE_METRICS`` is not 0); else the
        host ``update``, with a one-time warning."""
        if self.device_enabled():
            self.update_device(labels, preds)
            return
        self._warn_host_fallback()
        self.update(labels, preds)

    def accumulate_dict(self, label, pred):
        """``update_dict`` without the per-batch readback (see
        :meth:`accumulate`)."""
        if self.device_enabled():
            label, pred = self._select_dict(label, pred)
            self.update_device(label, pred)
            return
        self._warn_host_fallback()
        self.update_dict(label, pred)

    def _warn_host_fallback(self):
        if not env("MXNET_DEVICE_METRICS", True):
            return   # explicitly disabled: per-batch syncs are intended
        if getattr(self, "_host_sync_warned", False):
            return
        self._host_sync_warned = True
        logging.warning(
            "metric %r has no device form: accumulating on the host costs "
            "one readback a batch", self.name)

    def sync(self, state=None):
        """Fold the device-resident state (the pending one, or
        ``state``) into ``sum_metric`` / ``num_inst`` with ONE readback,
        counted by ``profiler.record_host_sync("metric.sync")``.  ``get``
        calls it, so a callback that reads the metric is the training
        loop's only sync point."""
        if state is None:
            state, self._device_state = self._device_state, None
            if state is None:
                return self
        self._fold_synced(_read_states([state])[0])
        return self

    def _fold_synced(self, host_state):
        s, n = host_state[:2]
        if (abs(s) >= 2 ** 24 or n < 0) \
                and not getattr(self, "_range_warned", False):
            self._range_warned = True
            logging.warning(
                "metric %r: device-resident accumulation exceeded the "
                "exact range of its (float32 sum, int32 count) state "
                "(sum=%s, count=%s); sync at shorter intervals or set "
                "MXNET_DEVICE_METRICS=0", self.name, s, n)
        self.sum_metric += float(s)
        self.num_inst += int(n)

    def _device_state_or_init(self):
        return self._device_state if self._device_state is not None \
            else self.device_init()

    def _absorb_device_state(self, state):
        self._device_state = state

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._pending = []
        self._device_state = None

    def get(self):
        self.sync()
        self._sync()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """reference: metric.py CompositeEvalMetric."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 and "
                              f"{len(self.metrics)}")

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    # -- device path: capable iff EVERY child is; the state is the tuple
    # of the children's states, which stay on the children --------------
    @property
    def device_capable(self):
        return bool(self.metrics) and \
            all(m.device_capable for m in self.metrics)

    def device_init(self):
        return tuple(m.device_init() for m in self.metrics)

    def device_update(self, state, labels, preds):
        return tuple(m.device_update(st, labels, preds)
                     for m, st in zip(self.metrics, state))

    def device_update_dict(self, state, label, pred):
        return tuple(m.device_update_dict(st, label, pred)
                     for m, st in zip(self.metrics, state))

    def update_device(self, labels, preds):
        self._absorb_device_state(self.device_update(
            self._device_state_or_init(), labels, preds))

    def accumulate(self, labels, preds):
        if self.device_enabled():
            self.update_device(labels, preds)
            return
        for metric in self.metrics:
            metric.accumulate(labels, preds)

    def accumulate_dict(self, label, pred):
        if self.device_enabled():
            self._absorb_device_state(self.device_update_dict(
                self._device_state_or_init(), label, pred))
            return
        for metric in self.metrics:
            metric.accumulate_dict(label, pred)

    def _device_state_or_init(self):
        return tuple(m._device_state_or_init() for m in self.metrics)

    def _absorb_device_state(self, state):
        for m, st in zip(self.metrics, state):
            m._absorb_device_state(st)

    def sync(self, state=None):
        """ONE readback for the whole composite: every child's pending
        state comes back together."""
        if state is not None:
            self._absorb_device_state(state)
        pend = [m for m in self.metrics if m._device_state is not None]
        if not pend:
            return self
        host = _read_states([m._device_state for m in pend])
        for m, h in zip(pend, host):
            m._device_state = None
            m._fold_synced(h)
        return self

    def reset(self):
        super().reset()
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        self.sync()
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


@register
class Accuracy(EvalMetric):
    """Share of rows whose argmax over ``axis`` equals the label
    (reference: metric.py Accuracy)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    device_capable = True

    def _terms(self, label, pred):
        label, pred = _t(label), _t(pred)
        if pred.shape != label.shape:
            pred = pred.argmax(dim=self.axis)
        pred = pred.to(torch.int32).reshape(-1)
        label = label.to(pred.device).to(torch.int32).reshape(-1)
        check_label_shapes(label, pred, shape=1)
        return (pred == label).sum(), pred.numel(), None


@register
class TopKAccuracy(EvalMetric):
    """Share of rows whose label is among the ``top_k`` largest scores
    (reference: metric.py TopKAccuracy).  Ties at the k-th place go to
    the lower index (a stable descending sort, the rule of the JAX
    package's ``lax.top_k``), and NaN ranks as the largest score.  A 1-d
    prediction holds class ids."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    device_capable = True

    def _terms(self, label, pred):
        pred = _t(pred)
        assert pred.dim() <= 2, "Predictions should be no more than 2 dims"
        label = _t(label).to(pred.device).to(torch.int32).reshape(-1)
        if pred.dim() == 1:
            hits = (pred.to(torch.int32) == label).sum()
        else:
            key = pred.float()
            key = torch.where(torch.isnan(key), math.inf, key)
            k = min(pred.shape[1], self.top_k)
            top = key.sort(dim=1, descending=True, stable=True)[1][:, :k]
            hits = (top == label[:, None]).any(dim=1).sum()
        return hits, pred.shape[0], None


class _DeferredBadLabels:
    """A metric whose labels are checked on the device: a batch with a
    label out of range adds nothing to the sums and counts itself in
    ``_bad`` (the device state's third slot, int32), and the next
    ``get()`` or ``sync`` raises ``_bad_exc``, again at every one until
    ``reset()`` (the JAX package's device path)."""

    _bad_exc = ValueError
    _bad_msg = "out-of-range labels in device-accumulated metric"

    def device_init(self):
        return (torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.int32),
                torch.zeros((), dtype=torch.int32))

    def _fold_synced(self, host_state):
        # the good batches first (the host path keeps the batches before
        # a bad one), then the flag; the raise is sync's
        s, n, bad = host_state
        if int(bad):
            self._bad_label_seen = True
        super()._fold_synced((s, n))

    def sync(self, state=None):
        out = super().sync(state)
        if getattr(self, "_bad_label_seen", False):
            raise self._bad_exc(self._bad_msg)
        return out

    def reset(self):
        super().reset()
        self._bad = []
        self._bad_label_seen = False

    def _count_bad(self, nbad):
        self._bad.append(nbad)

    def _sync(self):
        super()._sync()
        if self._bad:
            if sum(int(b) for b in self._bad):
                self._bad_label_seen = True
            self._bad = []
        if self._bad_label_seen:
            raise self._bad_exc(self._bad_msg)


_CLASS_RANGE_MSG = ("label index out of range for the class axis "
                    "(detected at metric sync; the host path raises "
                    "IndexError per batch)")


@register
class F1(_DeferredBadLabels, EvalMetric):
    """Binary F1 of a batch, averaged over batches (reference: metric.py
    F1): ``2 tp / (2 tp + fp + fn)``, 0 where that is 0/0; the
    prediction is the argmax over axis 1."""

    _bad_msg = "F1 currently only supports binary classification."

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    device_capable = True

    def _terms(self, label, pred):
        pred = _t(pred)
        label = _t(label).to(pred.device).to(torch.int32).reshape(-1)
        nbad = ((label < 0) | (label > 1)).sum()
        ok = nbad == 0
        pl = pred.argmax(dim=1).to(torch.int32)
        lb = label.clamp(0, 1)
        tp = ((pl == 1) & (lb == 1)).sum().double()
        fp = ((pl == 1) & (lb == 0)).sum().double()
        fn = ((pl == 0) & (lb == 1)).sum().double()
        denom = 2 * tp + fp + fn
        f1 = torch.where(denom > 0, 2 * tp / denom.clamp(min=1.0), 0.0)
        return torch.where(ok, f1, 0.0), ok.to(torch.int64), nbad


@register
class Perplexity(_DeferredBadLabels, EvalMetric):
    """exp of the mean negative log-probability of the labels, rows whose
    label is ``ignore_label`` left out (reference: metric.py Perplexity;
    probabilities floored at 1e-10)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    _bad_exc = IndexError
    _bad_msg = _CLASS_RANGE_MSG
    device_capable = True

    def _check(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("labels and preds differ in number")

    def _terms(self, label, pred):
        pred = _t(pred)
        nclass = pred.shape[-1]
        label = _t(label).to(pred.device).reshape(-1).to(torch.int64)
        if label.numel() * nclass != pred.numel():
            raise ValueError(f"shape mismatch: {tuple(label.shape)} vs. "
                             f"{tuple(pred.shape)}")
        nbad = ((label < -nclass) | (label >= nclass)).sum()
        ok = nbad == 0
        probs = pred.reshape(-1, nclass).gather(
            1, label.remainder(nclass)[:, None]).squeeze(1).float()
        count = label.numel()
        if self.ignore_label is not None:
            ignore = label == int(self.ignore_label)
            count = count - ignore.sum()
            probs = torch.where(ignore, torch.ones_like(probs), probs)
        loss = -probs.clamp(min=1e-10).log().sum()
        return torch.where(ok, loss, 0.0), torch.where(ok, count, 0), nbad

    def get(self):
        self.sync()
        self._sync()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class _RegressionMetric(EvalMetric):
    """A score of the residual ``label - pred`` per batch, averaged over
    batches; a 1-d label or prediction is a column."""

    device_capable = True

    def _terms(self, label, pred):
        pred = _t(pred)
        label = _t(label).to(pred.device)
        if label.dim() == 1:
            label = label[:, None]
        if pred.dim() == 1:
            pred = pred[:, None]
        return self._score(label - pred), 1, None


@register
class MAE(_RegressionMetric):
    """Mean absolute error (reference: metric.py MAE)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _score(err):
        return err.abs().mean()


@register
class MSE(_RegressionMetric):
    """Mean squared error (reference: metric.py MSE)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _score(err):
        return (err ** 2.0).mean()


@register
class RMSE(_RegressionMetric):
    """Root mean squared error of a batch, averaged over batches
    (reference: metric.py RMSE)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _score(err):
        return (err ** 2.0).mean().sqrt()


@register
class CrossEntropy(_DeferredBadLabels, EvalMetric):
    """Mean of ``-log(p[label] + eps)`` over rows (reference: metric.py
    CrossEntropy)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    _bad_exc = IndexError
    _bad_msg = _CLASS_RANGE_MSG
    device_capable = True

    def _terms(self, label, pred):
        pred = _t(pred)
        label = _t(label).to(pred.device).reshape(-1).to(torch.int64)
        if label.shape[0] != pred.shape[0]:
            raise ValueError(f"{label.shape[0]} labels for "
                             f"{pred.shape[0]} rows")
        nclass = pred.shape[-1]
        nbad = ((label < -nclass) | (label >= nclass)).sum()
        ok = nbad == 0
        prob = pred.gather(1, label.remainder(nclass)[:, None]) \
            .squeeze(1).float()
        return (torch.where(ok, -(prob + self.eps).log().sum(), 0.0),
                torch.where(ok, label.shape[0], 0), nbad)


@register
class NegativeLogLikelihood(CrossEntropy):
    """CrossEntropy under its NLL name (reference: metric.py
    NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r of a batch's predictions and labels, averaged over
    batches (reference: metric.py PearsonCorrelation; float64 on the
    device)."""

    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _terms(self, label, pred):
        check_label_shapes(label, pred, 1)
        pred = _t(pred).reshape(-1).double()
        label = _t(label).to(pred.device).reshape(-1).double()
        a, b = pred - pred.mean(), label - label.mean()
        r = (a * b).sum() / ((a * a).sum() * (b * b).sum()).sqrt()
        return r, 1, None


@register
class Loss(EvalMetric):
    """Mean of a loss-valued output (reference: metric.py Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    device_capable = True

    def _check(self, labels, preds):
        pass

    def _pairs(self, labels, preds):
        return ((None, pred) for pred in preds)

    def _terms(self, _, pred):
        pred = _t(pred)
        return pred.float().sum(), pred.numel(), None

    def update(self, _, preds):
        super().update(_, preds)

    def device_update(self, state, _, preds):
        return super().device_update(state, _, preds)


@register
class Torch(Loss):
    """Loss under the name ``torch`` (reference: metric.py Torch)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Loss under the name ``caffe`` (reference: metric.py Caffe)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, per output: a number (one
    instance) or a ``(sum, count)`` pair (reference: metric.py
    CustomMetric).  Reads each batch back to the host."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_numpy(label), _numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def _numpy(x):
    t = _t(x)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A CustomMetric over a function of numpy (label, pred) (reference:
    metric.py np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_METRIC_REGISTRY["acc"] = Accuracy
_METRIC_REGISTRY["top_k_acc"] = TopKAccuracy
_METRIC_REGISTRY["top_k_accuracy"] = TopKAccuracy
_METRIC_REGISTRY["ce"] = CrossEntropy
_METRIC_REGISTRY["cross-entropy"] = CrossEntropy
_METRIC_REGISTRY["nll_loss"] = NegativeLogLikelihood
_METRIC_REGISTRY["pearsonr"] = PearsonCorrelation
