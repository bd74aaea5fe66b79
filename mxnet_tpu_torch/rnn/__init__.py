"""Symbolic RNN cells + bucketing IO (reference: python/mxnet/rnn/)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell, ModifierCell,
                       BaseConvRNNCell, ConvRNNCell, ConvLSTMCell,
                       ConvGRUCell)
from .io import BucketSentenceIter, encode_sentences
