"""Run a test module's cases once per package (not collected).

:func:`both_packages` returns an autouse fixture, parametrized over the
JAX package and the port, that rebinds the module's package-bound names
(``mx``, ``profiler``, ``KVStoreServer`` ...) to the package of the
current case before it runs, so a case of the JAX package's own suite
runs as written against either package and each holds its goldens.  The
port's cases run inside ``with mt.cpu():``.  xdist's ``--dist
loadfile`` keeps a module on one worker, where its cases run in turn, so
the rebinding never races."""
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

PKGS = {"jax": mx, "port": mt}


def both_packages(module_globals, bind):
    """``bind(pkg) -> {name: object}``, applied to ``module_globals``
    before each case; the fixture yields the package module."""
    @pytest.fixture(params=list(PKGS), autouse=True)
    def pkg(request):
        p = PKGS[request.param]
        module_globals.update(bind(p))
        if p is mt:
            with mt.cpu():
                yield p
        else:
            yield p
    return pkg
