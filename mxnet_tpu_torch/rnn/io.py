"""Bucketing data iterator (reference: python/mxnet/rnn/io.py).

PyTorch counterpart of ``mxnet_tpu/rnn/io.py``.  ``BucketSentenceIter``
groups variable-length sentences into length buckets; each batch is
padded to its bucket length and tagged with ``bucket_key`` so
``BucketingModule`` selects the matching bucket's executor.  It
shuffles with ``random.shuffle`` and the global ``np.random``, as the
JAX package does, so the same seeds give the same batches in both
packages.  Batches are CPU NDArrays (as ``NDArrayIter``'s);
``Module.forward`` copies them to its device.  Pass ``dtype="int32"``
for token ids under a bf16 ``compute_dtype``, which casts every float
input (ids above 256 would round).
"""
from __future__ import annotations

import random

import numpy as np

from ..base import MXNetError
from ..io import DataBatch, DataIter, DataDesc
from ..context import cpu
from ..ndarray.ndarray import array as nd_array


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key='\n', start_label=0, unknown_token=None):
    """Map token sentences to int sequences (reference: rnn/io.py:30)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token, \
                    f"Unknown token {word}"
                if idx == invalid_label:
                    idx += 1
                if unknown_token and not new_vocab:
                    word = unknown_token
                else:
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """reference: rnn/io.py:74."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name='data',
                 label_name='softmax_label', dtype='float32',
                 layout='NT'):
        super().__init__()
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, j in enumerate(counts)
                       if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype).reshape(-1, b)
                     for i, b in zip(self.data, buckets)]
        if ndiscard:
            import logging
            logging.warning("discarded %d sentences longer than the "
                            "largest bucket.", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find('N')
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(batch_size, self.default_bucket_key),
                dtype=np.dtype(self.dtype), layout=self.layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(batch_size, self.default_bucket_key),
                dtype=np.dtype(self.dtype), layout=self.layout)]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(self.default_bucket_key, batch_size),
                dtype=np.dtype(self.dtype), layout=self.layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(self.default_bucket_key, batch_size),
                dtype=np.dtype(self.dtype), layout=self.layout)]
        else:
            raise MXNetError(
                "Invalid layout %s: Must by NT (batch major) or TN "
                "(time major)" % layout)

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        """reference: rnn/io.py:147."""
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd_array(buck, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd_array(label, ctx=cpu(),
                                         dtype=self.dtype))

    def next(self):
        """reference: rnn/io.py:162."""
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   dtype=np.dtype(self.dtype),
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape,
                                    dtype=np.dtype(self.dtype),
                                    layout=self.layout)])
