"""``nd.linalg`` (reference: python/mxnet/ndarray/linalg.py over
la_op.cc): one function a ``linalg_*`` op, as in
``mxnet_tpu/ndarray/linalg.py``."""
from .ndarray import _invoke


def _make(name, op):
    def f(*args, **kw):
        out = kw.pop("out", None)
        return _invoke(op, list(args), kw, out=out)
    f.__name__ = name
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
