"""Evaluation metrics.

PyTorch counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``,
``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss`` (and its
``Torch`` and ``Caffe`` names), ``CustomMetric`` with ``np`` and
``create``. A metric computes with
torch ops on the device its predictions live on and keeps its running
sums there, so a training step does not read the (B*S, vocab) softmax
back to the host; the host sees the sums only at ``get()`` (one
readback), as the JAX package's device-resident path does. Labels and
predictions may be NDArrays, tensors or numpy arrays.  Where the
host would have to look at a label to reject it (F1's labels outside
{0, 1}, CrossEntropy's and Perplexity's outside the class axis), the
batch is left out of the sums on the device and the error is raised at
the next ``get()``, as the JAX package's device path does.  A
``CustomMetric`` calls its Python function on numpy arrays, one readback
a batch.
"""
from __future__ import annotations

import math

import numpy  # `np` is the module-level metric factory below
import torch

from .base import MXNetError
from .ndarray import NDArray

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

    def get_config(self):
        """The metric's constructor arguments, class and names."""
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__,
                       "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

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


class _DeferredBadLabels:
    """A metric whose labels are checked on the device: a batch with a
    label out of range adds nothing to the sums and counts itself in
    ``_bad``, and the next ``get()`` raises ``_bad_exc``, again at every
    ``get()`` until ``reset()`` (the JAX package's device path)."""

    _bad_exc = ValueError
    _bad_msg = "out-of-range labels in device-accumulated metric"

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

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
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
            self._accumulate(torch.where(ok, f1, 0.0), ok.to(torch.int64))
            self._count_bad(nbad)


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
            self._accumulate(torch.where(ok, loss, 0.0),
                             torch.where(ok, count, 0))
            self._count_bad(nbad)

    def get(self):
        self._sync()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class _RegressionMetric(EvalMetric):
    """A score of the residual ``label - pred`` per batch, averaged over
    batches; a 1-d label or prediction is a column."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            label = _t(label).to(pred.device)
            if label.dim() == 1:
                label = label[:, None]
            if pred.dim() == 1:
                pred = pred[:, None]
            self._accumulate(self._score(label - pred), 1)


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

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
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
            self._accumulate(
                torch.where(ok, -(prob + self.eps).log().sum(), 0.0),
                torch.where(ok, label.shape[0], 0))
            self._count_bad(nbad)


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

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, 1)
            pred = _t(pred).reshape(-1).double()
            label = _t(label).to(pred.device).reshape(-1).double()
            a, b = pred - pred.mean(), label - label.mean()
            r = (a * b).sum() / ((a * a).sum() * (b * b).sum()).sqrt()
            self._accumulate(r, 1)


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
