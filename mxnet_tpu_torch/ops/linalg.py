"""Linear-algebra ops (``linalg_*``, ``khatri_rao``).

PyTorch counterpart of ``mxnet_tpu/ops/linalg.py`` (reference:
src/operator/tensor/la_op.cc): batched over leading dimensions, with
torch.linalg's LAPACK (CPU) and cuSOLVER / cuBLAS (card) routines where
the JAX package calls XLA's, and gradients from torch's autograd.
Triangular inputs are read as the JAX package reads them: ``potri``,
``trsm`` and ``trmm`` the lower triangle only.  ``gelqf`` is the LQ
factorisation through the QR of A^T; ``syevd`` returns the eigenvectors
as rows with the eigenvalues in ascending order (their signs, as any
eigensolver's, are not unique).
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x):
    return x.transpose(-1, -2)


@register("linalg_gemm", arg_names=["A", "B", "C"],
          attr_defaults={"transpose_a": False, "transpose_b": False,
                         "alpha": 1.0, "beta": 1.0})
def _gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
          **kw):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2", arg_names=["A", "B"],
          attr_defaults={"transpose_a": False, "transpose_b": False,
                         "alpha": 1.0})
def _gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **kw):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf", arg_names=["A"])
def _potrf(A, **kw):
    """The lower Cholesky factor L of A = L L^T."""
    return torch.linalg.cholesky(A)


@register("linalg_potri", arg_names=["A"])
def _potri(A, **kw):
    """(A A^T)^-1 from a lower-triangular A (potrf's output)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    linv = torch.linalg.solve_triangular(A, eye.expand(A.shape),
                                         upper=False)
    return torch.matmul(_t(linv), linv)


@register("linalg_trmm", arg_names=["A", "B"],
          attr_defaults={"transpose": False, "rightside": False,
                         "alpha": 1.0})
def _trmm(A, B, transpose=False, rightside=False, alpha=1.0, **kw):
    a = torch.tril(A)
    if transpose:
        a = _t(a)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_trsm", arg_names=["A", "B"],
          attr_defaults={"transpose": False, "rightside": False,
                         "alpha": 1.0})
def _trsm(A, B, transpose=False, rightside=False, alpha=1.0, **kw):
    """X with op(A) X = alpha B (B op(A) = ... if ``rightside``), A's lower
    triangle, op(A) = A^T if ``transpose``."""
    a = _t(A) if transpose else A
    return alpha * torch.linalg.solve_triangular(
        a, B, upper=bool(transpose), left=not rightside)


@register("linalg_syrk", arg_names=["A"],
          attr_defaults={"transpose": False, "alpha": 1.0})
def _syrk(A, transpose=False, alpha=1.0, **kw):
    a = _t(A) if transpose else A
    return alpha * torch.matmul(a, _t(a))


@register("linalg_gelqf", arg_names=["A"], num_outputs=2)
def _gelqf(A, **kw):
    """A = L Q through the QR of A^T: returns (L, Q)."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("linalg_sumlogdiag", arg_names=["A"])
def _sumlogdiag(A, **kw):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("linalg_syevd", arg_names=["A"], num_outputs=2)
def _syevd(A, **kw):
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("linalg_inverse", arg_names=["A"])
def _inverse(A, **kw):
    return torch.linalg.inv(A)


@register("linalg_det", arg_names=["A"])
def _det(A, **kw):
    return torch.linalg.det(A)


@register("linalg_slogdet", arg_names=["A"], num_outputs=2)
def _slogdet(A, **kw):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("khatri_rao", variadic=True)
def _khatri_rao(*args, **kw):
    """The column-wise Kronecker product (reference: contrib krprod)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ir,jr->ijr", out, m).reshape(-1, out.shape[1])
    return out
