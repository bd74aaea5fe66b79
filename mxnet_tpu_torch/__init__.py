"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one (``mxnet_tpu``), which stays the
reference it is tested against.  It keeps the JAX package's module layout
and names; inside, it is plain PyTorch on an explicit ``torch.device``,
and the JAX package's Pallas TPU kernels become kernels written by hand
for NVIDIA Hopper (``csrc/``), built at first use.

Entry points run on ``gpu(0)`` (``cuda:0``) unless the caller passes a
CPU context; without CUDA they raise.  Importing the package builds no
kernel and creates no CUDA context, thread or socket, except in a
process launched as a parameter server (``DMLC_ROLE=server``), which
serves from the import on (:mod:`.kvstore_server`).  It imports neither ``jax`` nor
anything of ``mxnet_tpu``.
"""
from .base import MXNetError, __version__
from .context import Context, cpu, cpu_pinned, gpu, num_gpus, \
    current_context
from . import base, context, profiler, ops, name, attribute
from .attribute import AttrScope
from . import symbol, executor, models
from . import serving, convert, cuda_lib
from . import ndarray, random, io, initializer, optimizer, lr_scheduler
from . import metric, model, callback, module, autograd, gluon, rnn, rtc
from . import operator
from . import operator as op
from . import kvstore
from . import kvstore as kv
from . import kvstore_server, distributed, compression, membership
from . import symbol as sym
from . import ndarray as nd
from . import module as mod
from . import initializer as init
from . import optimizer as opt
from .symbol import Symbol
from .executor import Executor
from .initializer import Initializer
from .optimizer import Optimizer
from .io import DataBatch, DataDesc, DataIter, NDArrayIter, ResizeIter, \
    PrefetchingIter, CSVIter
from . import native, recordio, image_record_iter
from .image_record_iter import ImageRecordIter, ImageRecordUInt8Iter
from . import image
from . import image as img
from .image.detection import ImageDetRecordIter
# the reference registers the record iterators in mx.io, and _v1 variants
# (src/io/io.cc:337-758), here the same classes, as in the JAX package
io.ImageRecordIter = io.ImageRecordIter_v1 = ImageRecordIter
io.ImageRecordUInt8Iter = io.ImageRecordUInt8Iter_v1 = ImageRecordUInt8Iter
io.ImageDetRecordIter = ImageDetRecordIter
from .module import Module, BaseModule
from . import tracing, health, checkpoint, compat_serialization
from . import monitor
from .monitor import Monitor
from . import visualization
from . import visualization as viz
from . import test_utils, contrib, notebook
from .ndarray import NDArray
from .convert import params_from_numpy, gluon_params_from_numpy, \
    gluon_params_to_numpy

__all__ = ["MXNetError", "Context", "cpu", "cpu_pinned", "gpu",
           "num_gpus", "current_context", "base", "context", "profiler",
           "ops", "name", "attribute", "AttrScope", "symbol", "Symbol",
           "Executor", "Initializer", "Optimizer", "opt", "DataBatch",
           "DataDesc", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "Module", "BaseModule", "NDArray",
           "sym", "executor", "models", "serving", "convert",
           "params_from_numpy", "cuda_lib", "ndarray", "nd", "random",
           "io", "initializer", "init", "optimizer", "lr_scheduler",
           "metric", "model", "callback", "module", "mod", "autograd",
           "gluon", "rnn", "rtc", "operator", "op", "native", "recordio",
           "image_record_iter", "ImageRecordIter", "ImageRecordUInt8Iter",
           "image", "img", "ImageDetRecordIter", "kvstore", "kv",
           "tracing", "health", "checkpoint", "compat_serialization",
           "monitor", "Monitor", "visualization", "viz", "test_utils",
           "contrib", "notebook", "kvstore_server", "distributed",
           "compression", "membership", "__version__"]

# A process launched with DMLC_ROLE=server (tools/launch.py -s S) becomes
# a parameter server here and never returns to the importer (reference:
# python/mxnet/kvstore_server.py:75); last, so the package is complete.
kvstore_server._init_kvstore_server_module()
