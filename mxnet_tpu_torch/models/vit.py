"""Vision Transformer classifier.

PyTorch counterpart of ``mxnet_tpu/models/vit.py``: the same graph and
names.  Built from the transformer LM's blocks with ``causal=False``,
so on the card its attention runs the hand-written flash-attention
kernels (forward, dQ and dK/dV) non-causal.  The patch embedding is one
strided ``Convolution``, and the head averages the patch tokens (no
class token) before the classifier.
"""
from __future__ import annotations

from .. import symbol as sym
from .transformer import _attention_block, _ffn_block


def vit(num_classes, image_shape=(3, 224, 224), patch_size=16,
        num_layers=12, d_model=384, num_heads=6, num_kv_heads=None,
        d_ff=None):
    """ViT classifier train symbol: data (B, C, H, W),
    softmax_label (B,).  Defaults ≈ ViT-S/16."""
    if isinstance(image_shape, str):   # registry convention: "3,224,224"
        image_shape = tuple(int(x) for x in image_shape.split(","))
    if d_model % num_heads:
        raise ValueError(
            f"vit: d_model {d_model} not divisible by num_heads "
            f"{num_heads} — head_dim must be integral or attention "
            "reshapes would straddle token boundaries")
    c, h, w = image_shape
    if h % patch_size or w % patch_size:
        raise ValueError(
            f"vit: image {h}x{w} not divisible by patch {patch_size}")
    gh, gw = h // patch_size, w // patch_size
    seq_len = gh * gw
    d_ff = d_ff or 4 * d_model

    data = sym.Variable("data")
    # patch embedding: one strided conv == per-patch linear projection
    x = sym.Convolution(data, num_filter=d_model,
                        kernel=(patch_size, patch_size),
                        stride=(patch_size, patch_size),
                        no_bias=False, name="patch_embed")
    x = sym.Reshape(x, shape=(-1, d_model, seq_len))   # (B, d, S)
    x = sym.transpose(x, axes=(0, 2, 1))               # (B, S, d)

    pos = sym.Variable("pos_embed_weight", shape=(seq_len, d_model))
    x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0))

    for i in range(num_layers):
        name = f"layer{i}"
        a = _attention_block(sym.LayerNorm(x, name=f"{name}_ln1"),
                             seq_len, d_model, num_heads, name,
                             num_kv_heads=num_kv_heads, causal=False)
        x = x + a
        f = _ffn_block(sym.LayerNorm(x, name=f"{name}_ln2"),
                       seq_len, d_model, d_ff, name)
        x = x + f
    x = sym.LayerNorm(x, name="final_ln")
    x = sym.mean(x, axis=1)                            # GAP over patches
    logits = sym.FullyConnected(x, num_hidden=num_classes, name="head")
    return sym.SoftmaxOutput(logits, name="softmax")


def get_symbol(num_classes=1000, **kwargs):
    return vit(num_classes, **kwargs)
