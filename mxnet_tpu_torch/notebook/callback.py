"""Notebook training-progress callbacks
(reference: python/mxnet/notebook/callback.py).

PyTorch counterpart of ``mxnet_tpu/notebook/callback.py``; ``pandas`` is
imported only when a DataFrame is asked for.

``PandasLogger`` collects train/eval metrics into pandas DataFrames for
notebook analysis.  The reference's live-plot layer (LiveBokehChart /
LiveLearningCurve) depends on bokeh, which isn't shipped here;
``LiveLearningCurve`` keeps the callback contract and metric
accumulation but does NOT render (with or without bokeh installed) —
plot the accumulated ``.train_data`` / ``.eval_data`` with any library.
"""
from __future__ import annotations

import time


class PandasLogger:
    """Accumulate per-batch train metrics, per-epoch eval metrics and
    timings into pandas DataFrames (reference: notebook/callback.py:71).
    """

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._train = []
        self._eval = []
        self._epoch = []
        self.last_time = time.time()
        self.start_time = time.time()

    @property
    def train_df(self):
        import pandas as pd
        return pd.DataFrame(self._train)

    @property
    def eval_df(self):
        import pandas as pd
        return pd.DataFrame(self._eval)

    @property
    def epoch_df(self):
        import pandas as pd
        return pd.DataFrame(self._epoch)

    @property
    def all_dataframes(self):
        return {'train': self.train_df, 'eval': self.eval_df,
                'epoch': self.epoch_df}

    def elapsed(self):
        return time.time() - self.start_time

    def _process_batch(self, param, rows):
        now = time.time()
        if param.eval_metric is not None:
            metrics = dict(param.eval_metric.get_name_value())
        else:
            metrics = {}
        speed = self.frequent * self.batch_size / (now - self.last_time) \
            if now > self.last_time else float('inf')
        metrics['batches_per_sec'] = speed / self.batch_size
        metrics['records_per_sec'] = speed
        metrics['elapsed'] = self.elapsed()
        metrics['minibatch_count'] = param.nbatch
        metrics['epoch'] = param.epoch
        rows.append(metrics)
        self.last_time = now

    def train_cb(self, param):
        if param.nbatch % self.frequent == 0:
            self._process_batch(param, self._train)

    def eval_cb(self, param):
        self._process_batch(param, self._eval)

    def epoch_cb(self):
        self._epoch.append({'elapsed': self.elapsed()})

    def callback_args(self):
        """kwargs for Module.fit wiring all callbacks
        (reference: notebook/callback.py:188)."""
        return {'batch_end_callback': self.train_cb,
                'eval_end_callback': self.eval_cb,
                'epoch_end_callback': lambda *a, **kw: self.epoch_cb()}


class LiveLearningCurve:
    """Callback-compatible metric accumulator with the reference
    LiveLearningCurve signature (reference: notebook/callback.py).

    Live bokeh rendering is NOT implemented (bokeh isn't shipped here);
    the callback contract and accumulated series (``.train_data`` /
    ``.eval_data`` as (epoch, [batch,] value) tuples) are, so notebooks
    plot with whatever is available.  ``display_freq`` is accepted for
    signature parity and unused."""

    def __init__(self, metric_name, display_freq=10, frequent=50):
        self.metric_name = metric_name
        self.display_freq = display_freq
        self.frequent = frequent
        self.train_data = []
        self.eval_data = []

    def train_cb(self, param):
        if param.nbatch % self.frequent == 0 \
                and param.eval_metric is not None:
            metrics = dict(param.eval_metric.get_name_value())
            if self.metric_name in metrics:
                self.train_data.append(
                    (param.epoch, param.nbatch,
                     metrics[self.metric_name]))

    def eval_cb(self, param):
        if param.eval_metric is not None:
            metrics = dict(param.eval_metric.get_name_value())
            if self.metric_name in metrics:
                self.eval_data.append(
                    (param.epoch, metrics[self.metric_name]))

    def callback_args(self):
        return {'batch_end_callback': self.train_cb,
                'eval_end_callback': self.eval_cb}
