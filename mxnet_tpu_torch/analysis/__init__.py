"""The part of ``mxnet_tpu/analysis/`` the distributed plane needs: the
happens-before sanitizer :mod:`.hb`, whose ``track`` and ``HBLock`` the
kvstore, its server and the membership math call.  The linter, the
lock-order shim and the scenario explorer are not ported (ROADMAP F1)."""
from . import hb  # noqa: F401
