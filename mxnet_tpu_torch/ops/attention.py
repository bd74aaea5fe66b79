"""Flash attention — forward as a hand-written Hopper kernel.

PyTorch counterpart of ``mxnet_tpu/ops/attention.py``.  The TPU package's
Pallas forward kernel (``_flash_fwd``) becomes ``csrc/flash_fwd.cu``,
built at first use and launched through ``ctypes``
(:func:`flash_fwd_cuda`).  Beside it sits the plain PyTorch version of the
same function (:func:`_attn_reference`), which a CPU or meta tensor takes
and against which the kernel is checked on the card.  A CUDA tensor always
launches the kernel, or the wrapper raises: nothing falls back.

Layout as in the JAX package: q (B, H, Sq, D), k/v (B, Hk, Sk, D) with Hk
dividing H (grouped-query attention shares each KV head among H/Hk query
heads).  Causal masking is top-left aligned (``k_pos <= q_pos``), also
when Sq != Sk.  The backward kernels (FA2 dQ and dK/dV) are not ported
yet, so this module is inference-only.
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
    (32, 64 or 128), shapes and contiguity, and raises on anything the
    kernel does not take.  Outputs are allocated here; the kernel runs
    on the current stream and is not synchronised.
    ``flash_fwd_cuda.launches`` counts successful launches."""
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
    return (out, lse) if return_lse else out


flash_fwd_cuda.launches = 0


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
    strided views; the kernel takes contiguous tensors."""
    return flash_attention(query.contiguous(), key.contiguous(),
                           value.contiguous(), bool(causal), scale)


def gqa_repeat_kv(q, k, v):
    """Validate GQA head counts and materialize KV at full head count."""
    H, Hk = q.shape[1], k.shape[1]
    if Hk == H:
        return k, v
    if H % Hk:
        raise ValueError(f"q heads {H} not divisible by kv heads {Hk}")
    g = H // Hk
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
