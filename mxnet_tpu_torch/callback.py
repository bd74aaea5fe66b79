"""Training callbacks (PyTorch counterpart of ``mxnet_tpu/callback.py``):
checkpoints at the end of an epoch (in the single-file format, or
sharded and asynchronous through :class:`checkpoint.AsyncCheckpointer`),
metric logging, ``Speedometer``, ``ProgressBar`` and
``LogValidationMetricsCallback``."""
from __future__ import annotations

import logging
import math
import time

from .model import save_checkpoint


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint`` every ``period``
    epochs (reference: callback.py:27)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1, sharded_async=False):
    """Epoch-end callback: ``model.save_checkpoint`` of the symbol and
    parameters every ``period`` epochs (reference: callback.py:55).

    ``sharded_async=True`` saves through
    :class:`checkpoint.AsyncCheckpointer` (the sharded format, a prefix
    an epoch): the epoch's end pays only the snapshot on the device and
    training goes on while the file is written.  The callback carries
    the checkpointer as ``_callback.checkpointer``; call its ``wait()``
    after ``fit`` before reading the last checkpoint."""
    period = int(max(1, period))
    if sharded_async:
        from .checkpoint import AsyncCheckpointer
        ck = AsyncCheckpointer()

        def _callback(iter_no, sym, arg, aux):
            if (iter_no + 1) % period == 0:
                ck.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
        _callback.checkpointer = ck
        return _callback

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log the training metric every ``period``
    batches (reference: callback.py log_train_metric).  Reading the
    metric is a device readback."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples per second and the training metric every ``frequent``
    batches (reference: callback.py Speedometer).  The interval is timed
    on the host clock; reading the metric is the loop's one device
    readback per interval, which also waits for the card to catch up."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        name_value = None
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if name_value is not None:
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """Batch-end callback: log a bar of ``length`` characters filled to
    ``nbatch / total`` (reference: callback.py ProgressBar).  It reads no
    metric, so it adds no readback."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Eval-end callback: log every validation metric (reference:
    callback.py LogValidationMetricsCallback).  Reading the metric is the
    validation pass's one readback."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
