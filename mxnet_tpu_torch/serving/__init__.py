"""Serving: production inference on the hardened kvstore wire.

PyTorch counterpart of ``mxnet_tpu/serving`` (TF-Serving's shape,
arXiv:1605.08695, on this codebase's transport):

* :class:`BucketedPredictor`: weights on the device, a batch padded to
  its bucket (``MXNET_SERVING_BUCKETS``), so N request sizes meet at most
  ``len(buckets)`` kernel shapes.
* :class:`DynamicBatcher`: continuous batching under
  ``MXNET_SERVING_MAX_WAIT_MS``, with queue-depth admission control
  shedding overload as a typed BUSY reply (:class:`BusyError`).
* :class:`ServingReplica`: a :class:`~mxnet_tpu_torch.kvstore_server.
  KVStoreServer` subclass serving ``predict`` / ``serving_stats`` /
  ``serving_refresh`` / ``drain`` envelopes over pipelined connections,
  hot-swapping weights pulled from live dist_async parameter servers on
  a version bump (train and serve from one parameter-server cluster).
* :class:`ServingClient`: the pipelined client riding the kvstore
  channel (reconnect, replay and heartbeats included).
* :class:`FleetClient`: a health-routed client over N replicas
  (weighted least-loaded routing, cross-replica retries under a deadline
  and a retry budget, drain, and a versioned canary with automatic
  rollback).

The frames are the JAX package's, so a client of either package drives
a replica of the other.  Every request records into
``profiler.record_latency``; ``profiler.latency_stats("serving.
request")`` gives p50 / p99 / QPS.
"""
from .bucketed import BucketedPredictor, parse_buckets
from .batcher import BusyError, DynamicBatcher
from .replica import ServingReplica, VERSION_KEY
from .client import PredictFuture, PredictTimeout, ServingClient
from .fleet import FleetClient, FleetError

__all__ = [
    "BucketedPredictor", "BusyError", "DynamicBatcher", "FleetClient",
    "FleetError", "PredictFuture", "PredictTimeout", "ServingClient",
    "ServingReplica", "VERSION_KEY", "parse_buckets", "publish_version",
]


def publish_version(kv, version=None):
    """Publish a serving weight version to the parameter servers the
    replicas watch.  Call AFTER the weights on the servers are the ones
    to serve (dist_async update-on-kvstore keeps them current by
    construction); replicas refresh on the next poll tick or
    ``serving_refresh`` envelope.

    ``version=None`` increments the currently-published version (single
    publisher: the trainer).  The counter is a float64 register written
    through :meth:`KVStore.assign` (updater-bypassing), never ``push``:
    a version bump must not be "applied" as a gradient."""
    import torch
    from ..base import MXNetError
    from ..ndarray import NDArray
    if version is None:
        out = NDArray(torch.zeros((1,), dtype=torch.float64))
        try:
            kv.pull(VERSION_KEY, out=out)
            current = int(round(float(out.asnumpy()[0])))
        except MXNetError:
            current = 0
        version = current + 1
    kv.assign(VERSION_KEY,
              NDArray(torch.tensor([float(version)], dtype=torch.float64)))
    return int(version)
