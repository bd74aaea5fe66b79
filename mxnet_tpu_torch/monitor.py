"""Monitor: statistics of every node's outputs during training.

PyTorch counterpart of ``mxnet_tpu/monitor.py`` (reference:
python/mxnet/monitor.py:33).  ``install`` sets the executor's monitor
callback (``Executor.set_monitor_callback``), which the interpreter
calls with each op node's outputs as it makes them; every ``interval``
batches, ``stat_func`` of each output whose name matches ``pattern`` is
kept.  The default statistic, the mean absolute value, is computed on
the outputs' device and stays there: ``toc`` reads every statistic of
the batch back at once (one host sync), then formats them as the JAX
package does.
"""
from __future__ import annotations

import logging
import re

import numpy as np
import torch

from .ndarray import NDArray
from . import profiler as _prof


def _asum_stat(x):
    """mean(|x|) in float32, a 0-d tensor on ``x``'s device; a floating
    value is reduced by one float32-accumulating norm, with no copy of
    it made (a bf16 logits output of a GPT-2-size LM is 0.8 GB)."""
    t = x._data
    with torch.no_grad():
        if t.is_floating_point():
            return torch.linalg.vector_norm(
                t, ord=1, dtype=torch.float32) / max(t.numel(), 1)
        return t.float().abs().mean()


class Monitor:
    """reference: monitor.py:33."""

    def __init__(self, interval, stat_func=None, pattern=".*",
                 sort=False):
        if stat_func is None:
            stat_func = _asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """reference: monitor.py install."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch (reference: monitor.py tic)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def _read_back(self):
        """The queue with every statistic that is a tensor (or NDArray)
        replaced by its numpy value, read back in one copy."""
        dev = [(i, v._data if isinstance(v, NDArray) else v)
               for i, (_, _, v) in enumerate(self.queue)
               if isinstance(v, (torch.Tensor, NDArray))]
        if not dev:
            return list(self.queue)
        flat = torch.cat([t.detach().reshape(-1).float() for _, t in dev])
        host = flat.cpu().numpy()
        _prof.record_host_sync("monitor.toc")
        out, off = list(self.queue), 0
        for i, t in dev:
            n = t.numel()
            v = host[off:off + n].astype(
                np.float32 if t.is_floating_point() else np.float64)
            off += n
            step, name, _ = out[i]
            out[i] = (step, name, v.reshape(())[()] if t.dim() == 0
                      else v.reshape(tuple(t.shape)))
        return out

    def toc(self):
        """Stop collecting; the (step, name, statistic) strings of the
        batch (reference: monitor.py toc)."""
        if not self.activated:
            return []
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        res = []
        for n, k, v_list in self._read_back():
            if isinstance(v_list, (list, tuple)):
                res.append((n, k, " ".join(str(v) for v in v_list)))
            else:
                res.append((n, k, str(v_list)))
        self.queue = []
        return res

    def toc_print(self):
        """reference: monitor.py toc_print."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
        return res
