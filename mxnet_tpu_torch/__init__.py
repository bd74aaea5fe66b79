"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one (``mxnet_tpu``), which stays the
reference it is tested against.  It keeps the JAX package's module layout
and names; inside, it is plain PyTorch on an explicit ``torch.device``,
and the JAX package's Pallas TPU kernels become kernels written by hand
for NVIDIA Hopper (``csrc/``), built at first use.

Entry points run on ``gpu(0)`` (``cuda:0``) unless the caller passes a
CPU context; without CUDA they raise.  Importing the package builds no
kernel and creates no CUDA context.  It imports neither ``jax`` nor
anything of ``mxnet_tpu``.
"""
from .base import MXNetError, __version__
from .context import Context, cpu, gpu, current_context
from . import base, context, profiler, ops, symbol, executor, models
from . import serving, convert, cuda_lib
from . import ndarray, random, io, initializer, optimizer, lr_scheduler
from . import metric, model, callback, module, autograd, gluon, rnn, rtc
from . import operator
from . import operator as op
from . import symbol as sym
from . import ndarray as nd
from . import module as mod
from . import initializer as init
from .convert import params_from_numpy, gluon_params_from_numpy, \
    gluon_params_to_numpy

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "base", "context", "profiler", "ops", "symbol",
           "sym", "executor", "models", "serving", "convert",
           "params_from_numpy", "cuda_lib", "ndarray", "nd", "random",
           "io", "initializer", "init", "optimizer", "lr_scheduler",
           "metric", "model", "callback", "module", "mod", "autograd",
           "gluon", "rnn", "rtc", "operator", "op", "__version__"]
