"""The port's operator registry covers the JAX package's: every op name
and alias that ``mxnet_tpu/ops`` registers is registered in
``mxnet_tpu_torch/ops``, but for the listed exceptions, each with its
reason.

Both registries are read in this test's own process, after importing
both packages (each import registers all of its ops), so the test does
not depend on which other tests ran in the same worker.  The port never
imports the JAX package; only this test does."""
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
