"""Gluon: the imperative high-level API (reference: python/mxnet/gluon/).

PyTorch counterpart of ``mxnet_tpu/gluon``: parameters, blocks and their
hybridization, the ``nn`` layers, the losses, the single-device
``Trainer``, ``utils``, ``data`` (datasets, samplers, the ``DataLoader``),
the vision model zoo, ``rnn`` (cells and the fused RNN / LSTM / GRU
layers) and ``contrib.rnn``.
"""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import data
from . import loss
from . import model_zoo
from . import utils
from . import rnn
from . import contrib
from .utils import split_and_load
