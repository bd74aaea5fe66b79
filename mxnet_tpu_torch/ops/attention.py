"""Flash attention — forward and backward as hand-written Hopper kernels.

PyTorch counterpart of ``mxnet_tpu/ops/attention.py``.  The TPU package's
Pallas kernels become CUDA kernels built at first use and launched through
``ctypes``: the forward (``_flash_fwd``) is ``csrc/flash_fwd.cu``
(:func:`flash_fwd_cuda`), the FlashAttention-2 backward (``_flash_bwd``:
the dQ kernel and the dK/dV kernel) is ``csrc/flash_bwd.cu``
(:func:`flash_bwd_cuda`).  In bf16 all three kernels run on the tensor
cores (``mma.sync``); in float32 all three run on the CUDA cores.  Beside
each sits the plain PyTorch version of the same function
(:func:`_attn_reference`,
:func:`_flash_bwd_reference`),
which a CPU or meta tensor takes and against which the kernels are checked
on the card.  A CUDA tensor always launches the kernel, or the wrapper
raises: nothing falls back.

:class:`FlashAttentionFunction` is the gradient, the counterpart of the
JAX package's ``custom_vjp`` (``_fa_fwd`` / ``_fa_bwd``): its forward
launches the forward kernel with the logsumexp output, its backward the
two backward kernels.  The registry op takes it when grad mode is on and
an input requires grad, and the lse-free forward otherwise.

Layout as in the JAX package: q (B, H, Sq, D), k/v (B, Hk, Sk, D) with Hk
dividing H (grouped-query attention shares each KV head among H/Hk query
heads).  Causal masking is top-left aligned (``k_pos <= q_pos``), also
when Sq != Sk.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .registry import register

_NEG_INF = -1e30

# head dims the kernel is instantiated for, and its dtype codes
KERNEL_HEAD_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_heads(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash attention wants 4-d q/k/v (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H, Hk = q.shape[1], k.shape[1]
    if Hk < 1 or H % Hk:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hk}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise MXNetError(f"flash attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")


def _check_aligned(who, named, dtypes=(torch.bfloat16,)):
    """Kernels that stage rows with 16-byte ``cp.async`` copies need every
    input of a dtype in ``dtypes`` to start on a 16-byte boundary (a
    fresh tensor does; a view with an odd storage offset may not): the
    forward's bf16 kernel, and both backward kernels in both dtypes."""
    for name, t in named:
        if t.dtype in dtypes and t.data_ptr() % 16:
            raise MXNetError(f"{who}: {name} does not start on a 16-byte "
                             f"boundary ({t.dtype} kernels copy 16-byte "
                             "chunks)")


def _attn_reference(q, k, v, causal, scale, return_lse=False):
    """Plain attention in f32 (the kernel's plain version; counterpart of
    the JAX package's ``_attn_reference``, which it extends with the
    logsumexp output).  KV heads are repeated per query-head group.
    Returns ``out`` in q's dtype, or ``(out, lse)`` with lse f32
    (B, H, Sq) when ``return_lse``."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if k.shape[1] != q.shape[1]:
        g = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_fwd_cuda(q, k, v, causal=False, scale=None, return_lse=False):
    """Launch the Hopper flash-attention forward on CUDA tensors.

    Checks device, dtype (float32 or bfloat16, all three alike), head dim
    (32, 64 or 128), shapes, contiguity and (bf16) 16-byte alignment, and
    raises on anything the kernel does not take.  Outputs are allocated
    here; the kernel runs on the current stream and is not synchronised.
    ``flash_fwd_cuda.launches`` counts successful launches, and
    ``flash_fwd_cuda.lse_launches`` those of them with the lse output."""
    _check_heads(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise MXNetError(f"flash_fwd_cuda: {name} is on {t.device}, "
                             f"q on {q.device}; all must be one CUDA device")
        if t.dtype != q.dtype:
            raise MXNetError(f"flash_fwd_cuda: {name} dtype {t.dtype} != "
                             f"q dtype {q.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_fwd_cuda: {name} is not contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"flash_fwd_cuda: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise MXNetError(f"flash_fwd_cuda: head dim {D} not supported "
                         f"({KERNEL_HEAD_DIMS})")
    _check_aligned("flash_fwd_cuda", (("q", q), ("k", k), ("v", v)))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    from .. import cuda_lib
    lib = cuda_lib.library("flash_fwd.cu")
    fn = lib.mxtt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_error_string.restype = ctypes.c_char_p
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             B, H, Hk, Sq, Sk, D, _KERNEL_DTYPES[q.dtype], int(bool(causal)),
             float(scale), q.device.index or 0, stream)
    if err != 0:
        raise MXNetError("flash_fwd_cuda: launch failed: "
                         f"{lib.mxtt_error_string(err).decode()} ({err})")
    flash_fwd_cuda.launches += 1
    if return_lse:
        flash_fwd_cuda.lse_launches += 1
    return (out, lse) if return_lse else out


flash_fwd_cuda.launches = 0
flash_fwd_cuda.lse_launches = 0


def _flash_bwd_reference(q, k, v, out, lse, dout, causal, scale,
                         delta=None):
    """Plain FlashAttention-2 backward in f32 (the backward kernels' plain
    version; counterpart of the JAX package's ``_flash_bwd``): recompute
    ``p = exp(s * scale - lse)`` under the forward's masks, then
    ``dS = p * (dO . v^T - delta) * scale``, ``dQ = dS . k``,
    ``dK = dS^T . q``, ``dV = p^T . dO``.  Per-query-head dK/dV are summed
    over each GQA group in f32 before the cast to k's dtype.  ``delta``
    (f32 ``rowsum(dO * O)``) is computed here when not given.  Returns
    ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = H // Hk
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    if delta is None:
        delta = (dout.to(f32) * out.to(f32)).sum(-1)
    qf, gf = q.to(f32), dout.to(f32)
    kf = k.to(f32).repeat_interleave(G, dim=1)
    vf = v.to(f32).repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp(s - lse.to(f32)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta.to(f32)[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dk = dk.reshape(B, Hk, G, Sk, D).sum(2)
    dv = dv.reshape(B, Hk, G, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_lib():
    from .. import cuda_lib
    lib = cuda_lib.library("flash_bwd.cu")
    if lib.mxtt_flash_bwd_dq.argtypes is None:
        tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.mxtt_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.mxtt_flash_bwd_dq.restype = ctypes.c_int
        lib.mxtt_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.mxtt_flash_bwd_dkv.restype = ctypes.c_int
        lib.mxtt_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd_inputs(q, k, v, out, lse, dout):
    _check_heads(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.device.type != "cuda" or t.device != q.device:
            raise MXNetError(f"flash_bwd_cuda: {name} is on {t.device}, "
                             f"q on {q.device}; all must be one CUDA device")
        if t.dtype != q.dtype:
            raise MXNetError(f"flash_bwd_cuda: {name} dtype {t.dtype} != "
                             f"q dtype {q.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_bwd_cuda: {name} is not contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"flash_bwd_cuda: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if out.shape != q.shape or dout.shape != q.shape:
        raise MXNetError(f"flash_bwd_cuda: out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise MXNetError(f"flash_bwd_cuda: head dim {q.shape[3]} not "
                         f"supported ({KERNEL_HEAD_DIMS})")
    _check_aligned("flash_bwd_cuda", (("q", q), ("k", k), ("v", v),
                                      ("dout", dout)), _KERNEL_DTYPES)
    _check_row_stat("lse", lse, q)


def _check_row_stat(name, t, q):
    """lse and delta: contiguous float32 (B, H, Sq) on q's device."""
    if (t.dtype != torch.float32 or t.shape != q.shape[:3]
            or t.device != q.device or not t.is_contiguous()):
        raise MXNetError(f"flash_bwd_cuda: {name} must be a contiguous "
                         f"float32 {tuple(q.shape[:3])} tensor on "
                         f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _bwd_args(q, k, causal, scale):
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    return (B, H, Hk, Sq, Sk, D, _KERNEL_DTYPES[q.dtype], int(bool(causal)),
            float(scale), q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(lib, err, what):
    if err != 0:
        raise MXNetError(f"flash_bwd_cuda: {what} launch failed: "
                         f"{lib.mxtt_error_string(err).decode()} ({err})")


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dQ kernel (K2) on checked inputs (see
    :func:`flash_bwd_cuda`); counts in ``flash_bwd_cuda.dq_launches``."""
    lib = _bwd_lib()
    dq = torch.empty_like(q)
    _raise_on(lib, lib.mxtt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_bwd_args(q, k, causal, scale)), "dQ")
    flash_bwd_cuda.dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dK/dV kernel (K3) on checked inputs (see
    :func:`flash_bwd_cuda`); counts in ``flash_bwd_cuda.dkv_launches``."""
    lib = _bwd_lib()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _raise_on(lib, lib.mxtt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_args(q, k, causal, scale)), "dK/dV")
    flash_bwd_cuda.dkv_launches += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, out, lse, dout, causal=False, scale=None,
                   delta=None):
    """Launch the Hopper flash-attention backward on CUDA tensors: the dQ
    kernel, then the dK/dV kernel, on the current stream, unsynchronised.

    q, out, dout (B, H, Sq, D) and k, v (B, Hk, Sk, D) in one dtype
    (float32 or bfloat16), contiguous, head dim 32/64/128; lse f32
    (B, H, Sq) from the forward.  ``delta`` = f32 ``rowsum(dout * out)``
    is computed here when not given.  Anything else raises.  Returns
    ``(dq, dk, dv)``; ``flash_bwd_cuda.dq_launches`` and
    ``.dkv_launches`` count successful launches."""
    _check_bwd_inputs(q, k, v, out, lse, dout)
    if delta is None:
        delta = (dout.float() * out.float()).sum(-1)
    _check_row_stat("delta", delta, q)
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


flash_bwd_cuda.dq_launches = 0
flash_bwd_cuda.dkv_launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                        delta=None):
    """Backward of :func:`flash_attention`: ``(dq, dk, dv)``.  A CUDA
    tensor launches the Hopper kernels; a CPU or meta tensor takes the
    plain version."""
    if q.device.type in ("cpu", "meta"):
        return _flash_bwd_reference(q, k, v, out, lse, dout, causal, scale,
                                    delta)
    if q.device.type == "cuda":
        return flash_bwd_cuda(q, k, v, out, lse, dout, causal, scale, delta)
    raise MXNetError(f"flash_attention_bwd: no path for device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient (counterpart of the JAX package's
    ``flash_attention`` ``custom_vjp``).  The forward keeps q, k, v, the
    output and the logsumexp; the backward makes dO contiguous (autograd
    hands over the graph's transposed view), takes ``delta = rowsum(dO *
    O)`` in f32 and runs the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention(q, k, v, causal, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale, delta)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False):
    """Blocked online-softmax attention (forward).  q: (B, H, Sq, D);
    k/v: (B, Hk, Sk, D) with Hk dividing H.  A CUDA tensor launches the
    Hopper kernel; a CPU or meta tensor takes the plain version."""
    _check_heads(q, k, v)
    if q.device.type in ("cpu", "meta"):
        return _attn_reference(q, k, v, causal, scale, return_lse)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale, return_lse)
    raise MXNetError(f"flash_attention: no path for device {q.device}")


@register("_contrib_FlashAttention",
          arg_names=["query", "key", "value"],
          attr_defaults={"causal": False, "scale": None},
          aliases=("flash_attention", "_contrib_flash_attention"))
def _flash_attention_op(query, key, value, causal=False, scale=None, **kw):
    """Registry entry point (reference: ops/attention.py
    _contrib_FlashAttention).  The graph's head transposes hand over
    strided views; the kernels take contiguous tensors.  With grad mode
    on and an input that requires grad it goes through
    :class:`FlashAttentionFunction` (forward with lse, backward kernels);
    otherwise through the lse-free forward, as serving does."""
    q, k, v = query.contiguous(), key.contiguous(), value.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, bool(causal), scale)
    return flash_attention(q, k, v, bool(causal), scale)


def gqa_repeat_kv(q, k, v):
    """Validate GQA head counts and materialize KV at full head count."""
    H, Hk = q.shape[1], k.shape[1]
    if Hk == H:
        return k, v
    if H % Hk:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hk}")
    g = H // Hk
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
