"""Training callbacks (subset; PyTorch counterpart of
``mxnet_tpu/callback.py``)."""
from __future__ import annotations

import logging
import time


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
