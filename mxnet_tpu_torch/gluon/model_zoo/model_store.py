"""Pretrained-model file cache (reference:
python/mxnet/gluon/model_zoo/model_store.py).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py``.
`get_model_file` fetches nothing: it resolves files already present under
the cache root and raises otherwise, with the path layout the reference
downloads into (~/.mxnet/models).
"""
from __future__ import annotations

import os

from ...base import MXNetError


def get_model_file(name, root=os.path.join('~', '.mxnet', 'models')):
    root = os.path.expanduser(root)
    file_path = os.path.join(root, f'{name}.params')
    if os.path.exists(file_path):
        return file_path
    raise MXNetError(
        f"Pretrained weights {file_path!r} not found. This package "
        f"fetches nothing — place the .params file there manually "
        f"(reference layout: model_store.py download cache)")


def purge(root=os.path.join('~', '.mxnet', 'models')):
    root = os.path.expanduser(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
