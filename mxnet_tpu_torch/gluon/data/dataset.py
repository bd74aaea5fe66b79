"""Datasets (reference: python/mxnet/gluon/data/dataset.py).

PyTorch counterpart of ``mxnet_tpu/gluon/data/dataset.py``."""
from __future__ import annotations

import threading



class Dataset:
    """reference: dataset.py:28."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of arrays or datasets of one length (reference:
    dataset.py:77); an item is one element of each, a tuple when there
    are several."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; {i}-th has " \
                f"{len(data)} vs {self._length}"
        self._data = list(args)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file and its .idx index (reference:
    dataset.py:108): item ``i`` is the raw record of the index's i-th
    key."""

    def __init__(self, filename):
        from ... import recordio
        idx_file = filename[:filename.rfind('.')] + '.idx'
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, 'r')
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        # one file handle: the DataLoader's worker threads take turns
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])
