"""Gluon Trainer, single device (reference: python/mxnet/gluon/trainer.py:27).

PyTorch counterpart of the single-device path of
``mxnet_tpu/gluon/trainer.py``: ``step(batch_size)`` sets the optimizer's
``rescale_grad`` to ``scale / batch_size`` and runs the port's updater on
each parameter with a gradient, one parameter at a time (the updater
rebinds each weight NDArray to its new tensor, under ``torch.no_grad``).
The kvstore argument takes ``None``, ``"device"`` or ``"local"``: one
device needs no reduction, so ``allreduce_grads`` does nothing.  The
distributed stores, ``mesh=`` and ``zero_stage=1`` are not ported
(ROADMAP E1, D1) and raise.  ``save_states`` / ``load_states`` write and
read the updater's states in the format both packages' ``Module`` and
``Trainer`` load.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import optimizer as opt_mod
from .. import profiler as _prof
from .parameter import ParameterDict, Parameter

_LOCAL_STORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None, mesh=None,
                 zero_stage=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}")
        if kvstore not in _LOCAL_STORES:
            raise MXNetError(f"Trainer(kvstore={kvstore!r}): distributed "
                             "kvstores are not ported to mxnet_tpu_torch "
                             "yet (ROADMAP E1)")
        if mesh is not None or zero_stage:
            raise MXNetError("Trainer(mesh=, zero_stage=): mesh training "
                             "is not ported to mxnet_tpu_torch yet "
                             "(ROADMAP D1)")
        if compression_params:
            raise MXNetError("Trainer(compression_params=): gradient "
                             "compression rides the distributed kvstore "
                             "(ROADMAP E1)")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(f"not a Parameter: {param!r}")
            param._trainer = self
            self._params.append(param)
        self._scale = 1.0
        self._kv_type = kvstore
        self._init_optimizer(optimizer, dict(optimizer_params or {}))

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an " \
                "Optimizer instance"
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = param_dict
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter with a gradient, the
        gradient scaled by ``1 / batch_size`` (reference: trainer.py:148)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        _prof.record_dispatch("trainer.step")
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == 'null':
                continue
            if param._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(
                        f"Parameter {param.name!r} was not initialized")
                continue
            updater(i, param.grad(), param.data())

    def allreduce_grads(self):
        """Nothing to reduce on one device (reference: trainer.py
        allreduce_grads)."""

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def step_k(self, loss_fn, data, label=None, k=None, batch_size=None,
               eval_metric=None):
        """K training steps, each ``record`` -> ``loss_fn(data_j[,
        label_j])`` -> ``backward`` -> :meth:`step`, over inputs stacked on
        a leading step axis; the K losses stacked (reference: the JAX
        package's ``Trainer.step_k``, whose one-program scan is not
        ported: this is its plain loop)."""
        import torch
        from .. import autograd
        from ..ndarray import NDArray

        def _parts(x):
            if x is None:
                return None
            return tuple(x) if isinstance(x, (list, tuple)) else (x,)
        data_t, label_t = _parts(data), _parts(label)
        ks = {int(a.shape[0]) for a in data_t + (label_t or ())}
        if len(ks) != 1:
            raise MXNetError(f"step_k: inconsistent leading (step) dims "
                             f"{sorted(ks)}")
        inferred = ks.pop()
        if inferred == 0:
            raise MXNetError("step_k: inputs stack ZERO steps (empty "
                             "leading axis)")
        k = inferred if k is None else k
        if k != inferred:
            raise MXNetError(f"step_k: k={k} but inputs stack {inferred} "
                             "steps (leading dim)")
        if batch_size is None:
            batch_size = int(data_t[0].shape[1]) \
                if len(data_t[0].shape) > 1 else 1

        def _at(parts, j):
            nds = tuple(p[j] for p in parts)
            return nds[0] if len(nds) == 1 else nds
        losses = []
        for j in range(k):
            args = [_at(data_t, j)]
            if label_t is not None:
                args.append(_at(label_t, j))
            with autograd.record():
                loss = loss_fn(*args)
            loss.backward()
            self.step(batch_size)
            if eval_metric is not None:
                labs = [p[j] for p in label_t] if label_t is not None \
                    else []
                eval_metric.update(labs, [loss])
            losses.append(loss._data.detach())
        return NDArray(torch.stack(losses))

    def save_states(self, fname):
        """The updater's states, in the format both packages load."""
        with open(fname, 'wb') as fout:
            fout.write(self._updaters[0].get_states())

    def load_states(self, fname):
        with open(fname, 'rb') as fin:
            self._updaters[0].set_states(fin.read())
