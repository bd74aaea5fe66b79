"""``sym.linalg`` — the symbolic linear-algebra namespace (reference:
python/mxnet/symbol/linalg.py): the same registered ``linalg_*`` ops as
``nd.linalg``, as in ``mxnet_tpu/symbol/linalg.py``."""
from __future__ import annotations


def _make(name, op):
    def f(*args, **kw):
        from .. import symbol as _sym
        return getattr(_sym, op)(*args, **kw)
    f.__name__ = name
    f.__doc__ = f"Symbolic {op} (the op of nd.linalg.{name})."
    return f


gemm = _make("gemm", "linalg_gemm")
gemm2 = _make("gemm2", "linalg_gemm2")
potrf = _make("potrf", "linalg_potrf")
potri = _make("potri", "linalg_potri")
trmm = _make("trmm", "linalg_trmm")
trsm = _make("trsm", "linalg_trsm")
syrk = _make("syrk", "linalg_syrk")
gelqf = _make("gelqf", "linalg_gelqf")
sumlogdiag = _make("sumlogdiag", "linalg_sumlogdiag")
syevd = _make("syevd", "linalg_syevd")
inverse = _make("inverse", "linalg_inverse")
det = _make("det", "linalg_det")
slogdet = _make("slogdet", "linalg_slogdet")
