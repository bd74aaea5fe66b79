"""Evaluation metrics (subset).

PyTorch counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``,
``Accuracy``, ``TopKAccuracy``, ``Perplexity``, ``CrossEntropy``,
``Loss``, ``CompositeEvalMetric`` and ``create``. A metric computes with
torch ops on the device its predictions live on and keeps its running
sums there, so a training step does not read the (B*S, vocab) softmax
back to the host; the host sees the sums only at ``get()`` (one
readback), as the JAX package's device-resident path does. Labels and
predictions may be NDArrays, tensors or numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

_METRIC_REGISTRY = {}


def _t(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a name, an EvalMetric or a list of them
    (reference: metric.py create)."""
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
    """Base metric (reference: metric.py EvalMetric).  Subclasses add
    per-batch sums with :meth:`_accumulate`; ``get`` folds them into
    ``sum_metric`` / ``num_inst``."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def _accumulate(self, total, count):
        """Add a batch's sum (a 0-d tensor on any device) and count (an
        int or 0-d tensor) without reading them back."""
        self._pending.append((total.double(), count))

    def _sync(self):
        if self._pending:
            s = sum(float(t) for t, _ in self._pending)
            n = sum(int(c) for _, c in self._pending)
            self._pending = []
            self.sum_metric += s
            self.num_inst += n

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._pending = []

    def get(self):
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

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        super().reset()
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
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

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _t(label), _t(pred)
            if pred.shape != label.shape:
                pred = pred.argmax(dim=self.axis)
            pred = pred.to(torch.int32).reshape(-1)
            label = label.to(pred.device).to(torch.int32).reshape(-1)
            check_label_shapes(label, pred, shape=1)
            self._accumulate((pred == label).sum(), pred.numel())


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

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
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
            self._accumulate(hits, pred.shape[0])


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels, rows whose
    label is ``ignore_label`` left out (reference: metric.py Perplexity;
    probabilities floored at 1e-10)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("labels and preds differ in number")
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            nclass = pred.shape[-1]
            label = _t(label).to(pred.device).reshape(-1).to(torch.int64)
            if label.numel() * nclass != pred.numel():
                raise ValueError(f"shape mismatch: {tuple(label.shape)} vs. "
                                 f"{tuple(pred.shape)}")
            probs = pred.reshape(-1, nclass).gather(
                1, label.remainder(nclass)[:, None]).squeeze(1).float()
            count = label.numel()
            if self.ignore_label is not None:
                ignore = label == int(self.ignore_label)
                count = count - ignore.sum()
                probs = torch.where(ignore, torch.ones_like(probs), probs)
            self._accumulate(-probs.clamp(min=1e-10).log().sum(), count)

    def get(self):
        self._sync()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    """Mean of ``-log(p[label] + eps)`` over rows (reference: metric.py
    CrossEntropy)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            label = _t(label).to(pred.device).reshape(-1).to(torch.int64)
            if label.shape[0] != pred.shape[0]:
                raise ValueError(f"{label.shape[0]} labels for "
                                 f"{pred.shape[0]} rows")
            prob = pred.gather(1, label[:, None]).squeeze(1).float()
            self._accumulate(-(prob + self.eps).log().sum(),
                             label.shape[0])


@register
class Loss(EvalMetric):
    """Mean of a loss-valued output (reference: metric.py Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        for pred in preds:
            pred = _t(pred)
            self._accumulate(pred.float().sum(), pred.numel())


_METRIC_REGISTRY["acc"] = Accuracy
_METRIC_REGISTRY["top_k_acc"] = TopKAccuracy
_METRIC_REGISTRY["top_k_accuracy"] = TopKAccuracy
_METRIC_REGISTRY["ce"] = CrossEntropy
_METRIC_REGISTRY["cross-entropy"] = CrossEntropy
