"""The port's operator registry covers the JAX package's: every op name
and alias that ``mxnet_tpu/ops`` registers is registered in
``mxnet_tpu_torch/ops``, but for the listed exceptions, each with its
reason.

Both registries are read in this test's own process, after importing
both packages (each import registers all of its ops), so the test does
not depend on which other tests ran in the same worker.  The port never
imports the JAX package; only this test does."""
import pytest

import mxnet_tpu  # noqa: F401  registers the JAX package's ops
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu_torch.ops import registry as treg
import torch_threads  # noqa: F401,E402  a worker's share of the cores

# JAX op names the port does not register yet, with the reason (none
# since C2, sparse storage, brought _sparse_retain / sparse_retain)
NOT_PORTED = {}


def test_every_jax_op_name_and_alias_is_registered_in_the_port():
    jax_names = set(jreg._OP_REGISTRY)
    port_names = set(treg._OP_REGISTRY)
    missing = jax_names - port_names
    assert missing == set(NOT_PORTED), sorted(missing ^ set(NOT_PORTED))
    assert len(jax_names) > 300          # the whole registry was read


def test_each_alias_names_the_same_op_as_in_the_jax_package():
    """Where the JAX package registers a name as an alias of an op, the
    port's name is an alias of the op of the same canonical name."""
    for name, jop in jreg._OP_REGISTRY.items():
        if name in NOT_PORTED:
            continue
        assert treg.get(name).name == jop.name, name


# -- the front end's modules ------------------------------------------------
import importlib  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402

# names the port's front-end modules lack, with the ROADMAP item that
# ports them (the record iterators came with C3, data IO; the
# single-process kvstore with C2; checkpoints and observability with C4
# and C6; the distributed plane with E1; the serving wire with T3 and
# elastic membership with E2's first half)
MODULE_NOT_PORTED = {
    # the JAX package's AOT artifact (jax.export to StableHLO), the
    # counterpart of the reference's C predict API: in PyTorch it would
    # be torch.export, which needs every hand-written kernel registered
    # as a custom op, the deployment story of the C ABI
    ("contrib.export", "export_symbol"): "C7 (the C ABI)",
    ("contrib.export", "export_checkpoint"): "C7 (the C ABI)",
    ("contrib.export", "ExportedModel"): "C7 (the C ABI)",
    ("contrib.export", "load"): "C7 (the C ABI)",
    # the same-host shm lane and its fault plan, which only the
    # hierarchical tier reaches: only E2's mesh leader serves the lane
    ("shmlane", "ShmLane"): "E2 (the hierarchical tier)",
    ("shmlane", "client_enabled"): "E2 (the hierarchical tier)",
    ("shmlane", "mode"): "E2 (the hierarchical tier)",
    ("shmlane", "ring_bytes"): "E2 (the hierarchical tier)",
    ("faultinject", "shm_drain_gate"): "E2 (the hierarchical tier)",
    ("faultinject", "shm_wedge_after_frames"): "E2 (the hierarchical tier)",
}
FRONT_END = ("optimizer", "metric", "initializer", "io", "callback",
             "model", "module", "attribute", "lr_scheduler", "kvstore")
# top-level names of the JAX package the port lacks, with the reason
TOP_NOT_PORTED = {
    "parallel": "D1 (multi-GPU)",
    "tpu": "by design: the port's devices are gpu(i)",
    "num_tpus": "by design: the port's devices are gpu(i)",
}


def _public(mod):
    """The public classes and functions a module of the JAX package
    defines itself (or in its submodules), and the ones it re-exports
    from another module of the package under an io name."""
    out = set()
    for n in dir(mod):
        obj = getattr(mod, n)
        where = getattr(obj, "__module__", None) or ""
        if n.startswith("_") or not callable(obj):
            continue
        reexported_iter = (mod.__name__ == "mxnet_tpu.io"
                           and where.startswith("mxnet_tpu.")
                           and n.endswith(("Iter", "Iter_v1")))
        if where.startswith(mod.__name__) or reexported_iter:
            out.add(n)
    return out


@pytest.mark.parametrize("name", FRONT_END)
def test_front_end_module_names_cover_the_jax_package(name):
    jmod = importlib.import_module("mxnet_tpu." + name)
    tmod = importlib.import_module("mxnet_tpu_torch." + name)
    missing = {n for n in _public(jmod) if not hasattr(tmod, n)}
    listed = {n for (m, n) in MODULE_NOT_PORTED if m == name}
    assert missing == listed, sorted(missing ^ listed)


# the checkpoint (C4) and observability (C6) modules
C4_C6 = ("checkpoint", "compat_serialization", "serialization", "callback",
         "tracing", "health", "profiler", "monitor", "visualization",
         "test_utils", "notebook", "notebook.callback", "contrib",
         "contrib.autograd", "contrib.tensorboard", "contrib.torch",
         "contrib.export")


@pytest.mark.parametrize("name", C4_C6)
def test_checkpoint_and_observability_names_cover_the_jax_package(name):
    """Every public name of the JAX package's C4 and C6 modules is in the
    port's module of the same name, but for the listed ones; a module
    the port lacks has every name listed."""
    jmod = importlib.import_module("mxnet_tpu." + name)
    try:
        tmod = importlib.import_module("mxnet_tpu_torch." + name)
    except ImportError:
        tmod = None
    missing = {n for n in _public(jmod)
               if tmod is None or not hasattr(tmod, n)}
    listed = {n for (m, n) in MODULE_NOT_PORTED if m == name}
    assert missing == listed, sorted(missing ^ listed)


def test_record_iterators_are_io_names_with_their_v1_aliases():
    """The JAX package registers the record iterators in ``io``, with the
    reference's ``_v1`` names for the same classes; so does the port."""
    import mxnet_tpu as mx
    for name in ("ImageRecordIter", "ImageRecordUInt8Iter"):
        assert getattr(mt.io, name + "_v1") is getattr(mt.io, name) \
            is getattr(mt, name)
        assert getattr(mx.io, name + "_v1") is getattr(mx.io, name)
    assert mt.io.ImageDetRecordIter is mt.ImageDetRecordIter
    # the port's native module is the host data path (the JAX package's
    # mxnet_tpu/native/__init__.py); the C ABI beside it is C7's
    assert hasattr(mt.native, "decode_augment_batch")
    assert not hasattr(mt.native, "capi")


def test_front_end_registries_cover_the_jax_package():
    """Every optimizer, metric and initializer name (aliases included)
    the JAX package registers creates an object in the port."""
    from mxnet_tpu.optimizer import _OPT_REGISTRY as jopt
    from mxnet_tpu.metric import _METRIC_REGISTRY as jmet
    from mxnet_tpu.initializer import _INIT_REGISTRY as jinit
    for name in jopt._entries:
        assert isinstance(mt.optimizer.create(name), mt.optimizer.Optimizer)
    for name, klass in jmet._entries.items():
        assert name in mt.metric._METRIC_REGISTRY, name
        assert mt.metric._METRIC_REGISTRY[name].__name__ == klass.__name__
    for name, klass in jinit._entries.items():
        assert mt.initializer._INIT_REGISTRY[name].__name__ == \
            klass.__name__, name


def test_top_level_names_differ_only_by_the_listed_set():
    """Read in a fresh process: a submodule another test imports (say
    ``mxnet_tpu.checkpoint``) becomes a name of the package there."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import json, mxnet_tpu, mxnet_tpu_torch\n"
            "print(json.dumps([sorted(dir(mxnet_tpu)), "
            "sorted(dir(mxnet_tpu_torch))]))")
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    jax_dir, port_dir = json.loads(res.stdout.strip().splitlines()[-1])
    missing = {n for n in jax_dir if not n.startswith("_")} - set(port_dir)
    assert missing == set(TOP_NOT_PORTED), sorted(
        missing ^ set(TOP_NOT_PORTED))


# the distributed plane (E1): every public name of these JAX modules is in
# the port's module of the same name, but for the listed ones; a module
# the port lacks (shmlane, E2) has every name listed
E1 = ("kvstore", "kvstore_server", "distributed", "compression",
      "wirecodec", "faultinject", "shmlane", "membership", "analysis.hb")


@pytest.mark.parametrize("name", E1)
def test_distributed_plane_names_cover_the_jax_package(name):
    jmod = importlib.import_module("mxnet_tpu." + name)
    try:
        tmod = importlib.import_module("mxnet_tpu_torch." + name)
    except ImportError:
        tmod = None
    missing = {n for n in _public(jmod)
               if tmod is None or not hasattr(tmod, n)}
    listed = {n for (m, n) in MODULE_NOT_PORTED if m == name}
    assert missing == listed, sorted(missing ^ listed)


# the serving wire (T3): every public name of the JAX package's serving
# modules is in the port's module of the same name
SERVING = ("serving", "serving.bucketed", "serving.batcher",
           "serving.replica", "serving.client", "serving.fleet")


@pytest.mark.parametrize("name", SERVING)
def test_serving_names_cover_the_jax_package(name):
    jmod = importlib.import_module("mxnet_tpu." + name)
    tmod = importlib.import_module("mxnet_tpu_torch." + name)
    missing = {n for n in _public(jmod) if not hasattr(tmod, n)}
    assert missing == set(), sorted(missing)


def test_serving_all_equals_the_jax_package():
    import mxnet_tpu.serving as jserving
    assert sorted(mt.serving.__all__) == sorted(jserving.__all__)
    for n in jserving.__all__:
        assert hasattr(mt.serving, n), n
    assert mt.serving.VERSION_KEY == jserving.VERSION_KEY
