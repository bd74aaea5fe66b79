"""Vision datasets (reference: python/mxnet/gluon/data/vision.py).

PyTorch counterpart of ``mxnet_tpu/gluon/data/vision.py``: MNIST,
FashionMNIST and CIFAR10 parse the reference's on-disk formats (idx-ubyte,
CIFAR binary) from local files only; nothing is downloaded.  The images
are read once into host memory and a sample is a uint8 NDArray view of
it on the CPU; the ``DataLoader`` moves each batch to the caller's
context in one copy.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...base import MXNetError
from ...context import cpu
from ...ndarray import NDArray
from .dataset import Dataset, RecordFileDataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx-ubyte(.gz) files (reference: vision.py:36)."""

    def __init__(self, root='~/.mxnet/datasets/mnist', train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        if self._train:
            data_file = 'train-images-idx3-ubyte'
            label_file = 'train-labels-idx1-ubyte'
        else:
            data_file = 't10k-images-idx3-ubyte'
            label_file = 't10k-labels-idx1-ubyte'

        def _open(base):
            for cand, op in ((base, open), (base + '.gz', gzip.open)):
                p = os.path.join(self._root, cand)
                if os.path.exists(p):
                    return op(p, 'rb')
            raise MXNetError(
                f"MNIST file {base}(.gz) not found under {self._root} "
                f"(no network egress; place it there manually)")

        with _open(label_file) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8) \
                .astype(np.int32)
        with _open(data_file) as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(num, rows, cols, 1)
        self._data = NDArray(data, ctx=cpu())
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root='~/.mxnet/datasets/fashion-mnist', train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from local binary batches (reference: vision.py:86)."""

    def __init__(self, root='~/.mxnet/datasets/cifar10', train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        if not os.path.exists(filename):
            raise MXNetError(
                f"CIFAR file {filename} not found (no network egress; "
                f"place it there manually)")
        with open(filename, 'rb') as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8) \
                .reshape(-1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = [os.path.join(self._root, f'data_batch_{i}.bin')
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, 'test_batch.bin')]
        data, label = zip(*(self._read_batch(f) for f in files))
        self._data = NDArray(np.concatenate(data), ctx=cpu())
        self._label = np.concatenate(label)


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a RecordIO file (reference: vision.py:130): item
    ``i`` is (image, label), the image decoded by PIL (``imdecode``) into
    an HWC uint8 NDArray on the CPU, as the other vision datasets keep
    their samples; the ``DataLoader`` moves each batch to the caller's
    context in one copy."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ... import recordio, image
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = NDArray(image.imdecode(img, self._flag, to_ndarray=False),
                      ctx=cpu())
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
