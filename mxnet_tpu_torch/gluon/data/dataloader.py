"""DataLoader (reference: python/mxnet/gluon/data/dataloader.py).

PyTorch counterpart of ``mxnet_tpu/gluon/data/dataloader.py``.  As
there, workers are a thread pool with a bounded prefetch window (two
batches a worker), not forked processes.  The default context is
thread-local (``context.py``), so a worker would not see the caller's
``with mt.cpu():``: the loader takes the caller's context when iteration
starts, a worker stacks each batch into host tensors (pinned when the
target is a GPU), and the caller's thread moves it with one
``non_blocking`` copy.  NDArray samples are stacked on their own device,
with no round trip through the host.  A custom ``batchify_fn`` runs in
the worker inside the caller's context.  Without a context the batches
go to ``gpu(0)``, and without CUDA that raises, as ``nd.array`` does.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...context import Context, current_context
from ...ndarray import NDArray
from .sampler import SequentialSampler, RandomSampler, BatchSampler


def _stack_host(data, pin=False):
    """Samples stacked into a tensor (nested lists for tuple samples):
    NDArrays on their own device, anything else through numpy into a host
    tensor, pinned with ``pin``.  numpy's dtype is kept, float64 but
    becoming float32, as ``nd.array`` keeps it."""
    if isinstance(data[0], NDArray):
        t = torch.stack([d.as_torch() for d in data])
        return t.pin_memory() if pin and t.device.type == "cpu" else t
    if isinstance(data[0], tuple):
        return [_stack_host(list(i), pin) for i in zip(*data)]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.pin_memory() if pin else t


def _to_device(batch, device):
    if isinstance(batch, list):
        return [_to_device(b, device) for b in batch]
    return NDArray(batch.to(device, non_blocking=True))


def default_batchify_fn(data):
    """Stack samples into a batch on the current context (reference:
    dataloader.py:36); tuple samples give a list, one batch a field."""
    return _to_device(_stack_host(data), current_context().torch_device())


class DataLoader:
    """reference: dataloader.py:66."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn
        self._num_workers = num_workers

    def __iter__(self):
        ctx = current_context()
        device = ctx.torch_device()     # raises at once without CUDA
        pin = device.type == "cuda"

        def fetch(batch):
            samples = [self._dataset[i] for i in batch]
            if self._batchify_fn is None:
                return _stack_host(samples, pin)
            with Context(ctx):      # a scope of the worker's own
                return self._batchify_fn(samples)

        def place(fetched):
            if self._batchify_fn is None:
                return _to_device(fetched, device)
            return fetched

        if self._num_workers <= 0:
            for batch in self._batch_sampler:
                yield place(fetch(batch))
            return
        with ThreadPoolExecutor(self._num_workers) as pool:
            pending = deque()
            for batch in self._batch_sampler:
                pending.append(pool.submit(fetch, batch))
                if len(pending) >= 2 * self._num_workers:
                    yield place(pending.popleft().result())
            while pending:
                yield place(pending.popleft().result())

    def __len__(self):
        return len(self._batch_sampler)
