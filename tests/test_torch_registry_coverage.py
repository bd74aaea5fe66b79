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

# JAX op names the port does not register yet, with the reason
NOT_PORTED = {
    "_sparse_retain": "row-sparse arrays: ROADMAP C2 (sparse)",
    "sparse_retain": "alias of _sparse_retain: ROADMAP C2 (sparse)",
}


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
# ports them (the record iterators came with C3, data IO)
MODULE_NOT_PORTED = {}
FRONT_END = ("optimizer", "metric", "initializer", "io", "callback",
             "model", "module", "attribute", "lr_scheduler")
# top-level names of the JAX package the port lacks, with the reason
TOP_NOT_PORTED = {
    "Monitor": "C6 (observability)",
    "monitor": "C6 (observability)",
    "tracing": "C6 (observability)",
    "health": "C6 (observability)",
    "visualization": "C6 (observability)",
    "viz": "C6 (observability)",
    "test_utils": "C6 (observability)",
    "notebook": "C6 (observability)",
    "contrib": "C6 (observability: contrib autograd, export, tensorboard)",
    "kv": "E1-E2 (the distributed plane)",
    "kvstore": "E1-E2 (the distributed plane)",
    "kvstore_server": "E1-E2 (the distributed plane)",
    "membership": "E1-E2 (the distributed plane)",
    "faultinject": "E1-E2 (the distributed plane)",
    "wirecodec": "E1-E2 (the distributed plane)",
    "compression": "E1-E2 (the distributed plane)",
    "parallel": "D1 (multi-GPU)",
    "analysis": "F1 (tooling)",
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
