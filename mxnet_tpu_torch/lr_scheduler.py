"""Learning-rate schedulers (subset; PyTorch counterpart of
``mxnet_tpu/lr_scheduler.py``, itself the reference's
python/mxnet/lr_scheduler.py).  Pure host arithmetic."""
from __future__ import annotations

import logging


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, floored at
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at "
                             "%0.5e, will not change in the future",
                             num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr
