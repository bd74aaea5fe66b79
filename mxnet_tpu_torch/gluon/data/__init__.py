"""Gluon data API (reference: python/mxnet/gluon/data/).

PyTorch counterpart of ``mxnet_tpu/gluon/data``: datasets, samplers, the
``DataLoader`` (worker threads, batches moved to the caller's context)
and the vision datasets read from local files."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision
