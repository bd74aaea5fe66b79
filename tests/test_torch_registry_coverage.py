"""The port's operator registry covers the JAX package's: every op name
and alias that ``mxnet_tpu/ops`` registers is registered in
``mxnet_tpu_torch/ops``, but for the listed exceptions, each with its
reason.  The modules' names do too, and the public API of every module
both packages have: every public class and function, every public
attribute of a class and every method's parameter names, against the
listed by-design absences (``API_ABSENT``, ``SIGNATURE_DIFFERS``,
``PORT_EXTRA_PARAMS``).

Both registries are read in this test's own process, after importing
both packages (each import registers all of its ops), so the test does
not depend on which other tests ran in the same worker.  The port never
imports the JAX package; only this test does."""
import inspect
import os

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
# and C6; the distributed plane with E1; the serving wire with T3;
# elastic membership, the hierarchical tier and its shm lane with E2)
MODULE_NOT_PORTED = {
    # the JAX package's AOT artifact (jax.export to StableHLO), the
    # counterpart of the reference's C predict API: in PyTorch it would
    # be torch.export, which needs every hand-written kernel registered
    # as a custom op, the deployment story of the C ABI
    ("contrib.export", "export_symbol"): "C7 (the C ABI)",
    ("contrib.export", "export_checkpoint"): "C7 (the C ABI)",
    ("contrib.export", "ExportedModel"): "C7 (the C ABI)",
    ("contrib.export", "load"): "C7 (the C ABI)",
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


# the distributed plane (E1, and E2's shm lane): every public name of these
# JAX modules is in the port's module of the same name, but for the listed
# ones
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


# -- the public API of every ported module ------------------------------------
# Every public class and function a module of the JAX package defines is in
# the port's module of the same name, and every public attribute of such a
# class is on the port's class, with the JAX method's parameter names among
# the port method's (the port may add its own after them: ``ctx``,
# ``compute_dtype``, a ``timeout``), but for the listed absences, each with
# its reason.  (module, class or None, attribute or name) -> reason; a class
# "*" is every class of the module.
_JAX_ONLY = "by design: it exists for XLA / jax.jit and has no meaning in " \
            "the port, which runs eagerly on torch"
API_ABSENT = {
    ("context", "Context", "jax_device"):
        "by design: the PJRT device of the JAX package; the port's is "
        "Context.torch_device",
    ("context", None, "tpu"): "by design: the port's devices are gpu(i)",
    ("context", None, "num_tpus"): "by design: the port's devices are gpu(i)",
    ("module.module", "Module", "fused_step_hlo"):
        "by design: the HLO text of the jitted fused step",
    ("module.module", "Module", "fused_step_flops"):
        "by design: XLA's cost analysis of the jitted fused step",
    ("optimizer", "*", "hyperparam_signature"):
        "by design: the key of the JAX package's compiled-update cache",
    ("optimizer", "*", "pure_update"):
        "by design: the functional update traced into the JAX package's "
        "lax.scan of K steps; the port's run_steps runs the stateful update",
    ("rtc", None, "PallasKernel"):
        "by design: a Pallas kernel; the port's run-time kernels are "
        "CUDA (rtc.CudaModule), and the Pallas doubler's port is "
        "csrc/rtc_doubler.cu",
    ("base", None, "Registry"):
        "by design: the JAX package's generic registry class; the port's "
        "registries are the op registry (ops.registry) and plain dicts",
    ("base", None, "tag_for_remat"): "by design: a jax.checkpoint name "
        "for XLA's rematerialization policy",
    ("base", None, "list_env_tunables"):
        "F1 (tooling): the autotuner's search spaces (declare_env(tune=)) "
        "come with the port of autotune/",
    ("random", None, "next_key"): "by design: JAX PRNG keys; the port's "
        "streams are torch generators (random.seed)",
    ("random", None, "split_key"): "by design: JAX PRNG keys",
    ("random", None, "key_for"): "by design: JAX PRNG keys",
    ("executor", "Executor", "set_shardings"):
        "D1 (multi-GPU): GSPMD shardings of the arguments",
    ("executor", None, "maybe_mirror"): _JAX_ONLY + " (jax.checkpoint "
        "under MXNET_BACKWARD_DO_MIRROR)",
    ("executor", None, "build_multi_step"): _JAX_ONLY + " (the K-step "
        "lax.scan program)",
    ("executor", None, "scan_cache_lookup"): _JAX_ONLY + " (the compiled "
        "scan cache)",
    ("executor", None, "scan_cache_store"): _JAX_ONLY + " (the compiled "
        "scan cache)",
    ("executor", None, "precompute_step_schedules"): _JAX_ONLY + " (the "
        "learning rates of a scan, computed before it is traced)",
    ("executor", None, "schedule_rollback"): _JAX_ONLY + " (the schedule "
        "of a failed donated scan)",
    ("executor", None, "make_lazy_outputs"): _JAX_ONLY + " (outputs "
        "materialized from a fused jitted step)",
    ("executor", None, "poison_stale"): _JAX_ONLY + " (outputs whose "
        "buffers a donated step consumed)",
    ("module.base_module", None, "chunked_device_get"): _JAX_ONLY +
        " (jax.device_get in chunks)",
    ("ops.attention", None, "pick_attention_config"):
        "P1 (speed): the JAX package's per-shape table was measured on a "
        "TPU; the port needs its own, measured on the card",
    ("ops.attention", None, "pick_attention_impl"):
        "P1 (speed): as pick_attention_config",
}
# methods whose JAX parameter names the port's lack, with the reason
SIGNATURE_DIFFERS = {
    ("kvstore", "KVStoreDistAsync", "ship_chunk_steps"):
        "the port's chunk holds card tensors as well as numpy arrays, so "
        "its parameter is grads, not grads_np",
    ("gluon.rnn.rnn_layer", "*", "forward"):
        "the states come positionally (*states): a hybridized parent's "
        "trace passes them one by one, a user's call as one list",
}
# parameters the port's methods add to the JAX package's, documented here
PORT_EXTRA_PARAMS = {
    ("checkpoint", "AsyncCheckpointer", "wait"): ("timeout",
        "a bounded wait for the writer thread"),
}


def _module_names(root):
    out = set()
    base = os.path.join(REPO, root)
    for d, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), base)[:-3]
                rel = rel.replace(os.sep, ".")
                if rel.endswith("__init__"):
                    rel = rel[:-len(".__init__")] if "." in rel else ""
                if rel and not any(p.startswith("_")
                                   for p in rel.split(".")):
                    out.add(rel)
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED_MODULES = sorted(_module_names("mxnet_tpu")
                        & _module_names("mxnet_tpu_torch"))


def _params(f):
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return None
    ps = list(sig.parameters.values())
    if any(p.kind == p.VAR_KEYWORD for p in ps):
        return None            # takes every keyword
    return [p.name for p in ps
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _listed(table, mod, cls, attr):
    return (mod, cls, attr) in table or (mod, "*", attr) in table


def _api_differences(name):
    jmod = importlib.import_module("mxnet_tpu." + name)
    tmod = importlib.import_module("mxnet_tpu_torch." + name)
    absent, sigs = set(), set()
    for n, obj in vars(jmod).items():
        if n.startswith("_") or not callable(obj) or \
                getattr(obj, "__module__", "") != jmod.__name__:
            continue
        tobj = getattr(tmod, n, None)
        if tobj is None:
            absent.add((name, None, n))
            continue
        if not (inspect.isclass(obj) and inspect.isclass(tobj)):
            continue
        for a in sorted(set(dir(obj)) | {"__init__"}):
            if a.startswith("_") and a != "__init__":
                continue
            if not hasattr(tobj, a):
                absent.add((name, n, a))
                continue
            f, g = getattr(obj, a), getattr(tobj, a)
            if not (callable(f) and callable(g)) or inspect.isclass(f):
                continue
            pf, pg = _params(f), _params(g)
            if pf is not None and pg is not None and set(pf) - set(pg):
                sigs.add((name, n, a))
    return absent, sigs


@pytest.mark.parametrize("name", PORTED_MODULES)
def test_public_api_of_ported_classes_matches_the_jax_package(name):
    """The gate of the public API: names, class attributes and the
    methods' parameter names, against the listed by-design absences."""
    absent, sigs = _api_differences(name)
    unlisted = sorted(k for k in absent if not _listed(API_ABSENT, *k))
    assert not unlisted, unlisted
    unlisted = sorted(k for k in sigs
                      if not _listed(SIGNATURE_DIFFERS, *k))
    assert not unlisted, unlisted


def test_api_absences_listed_are_absent():
    """Every listed absence is real (a repaired one leaves the list)."""
    seen_absent, seen_sigs = set(), set()
    for name in PORTED_MODULES:
        absent, sigs = _api_differences(name)
        seen_absent |= {(m, c, a) for m, c, a in absent}
        seen_sigs |= sigs
    for mod, cls, attr in API_ABSENT:
        assert any(m == mod and a == attr and (cls in ("*", c))
                   for m, c, a in seen_absent), (mod, cls, attr)
    for mod, cls, attr in SIGNATURE_DIFFERS:
        assert any(m == mod and a == attr and (cls in ("*", c))
                   for m, c, a in seen_sigs), (mod, cls, attr)
    for (mod, cls, attr), (param, _why) in PORT_EXTRA_PARAMS.items():
        j = getattr(getattr(importlib.import_module("mxnet_tpu." + mod),
                            cls), attr)
        t = getattr(getattr(importlib.import_module(
            "mxnet_tpu_torch." + mod), cls), attr)
        assert param in _params(t) and param not in _params(j)
