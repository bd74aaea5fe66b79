"""Serving (subset): bucketed predict dispatch and the dynamic batcher.

PyTorch counterpart of ``mxnet_tpu/serving``.  ``ServingReplica``, the
client and the fleet router are not ported yet.
"""
from .bucketed import BucketedPredictor, parse_buckets
from .batcher import BusyError, DynamicBatcher

__all__ = ["BucketedPredictor", "BusyError", "DynamicBatcher",
           "parse_buckets"]
