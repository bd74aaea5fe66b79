"""Decoder-only transformer language model and its KV-cache decode step.

PyTorch counterpart of ``transformer_lm`` and ``transformer_decode_step``
in ``mxnet_tpu/models/transformer.py``: the same graphs, with the same
node and parameter names, so weights and symbol JSON move between the two
packages unchanged, and an LM's weights load into its decode step.
Attention in the LM runs ``sym.contrib.FlashAttention``, which on the
card is the hand-written flash-attention kernel; the decode step attends
over its cache with ``batch_dot`` and a masked ``softmax``.  Pre-norm
residual blocks; FFN gelu (sigmoid approximation) or SwiGLU; positions
learned or rotary; grouped-query attention through ``num_kv_heads``.
"""
from .. import symbol as sym
from ..base import MXNetError

import math


def _check_moe(who, moe_experts):
    if moe_experts:
        raise MXNetError(f"{who}: moe_experts>0 needs the MoE op, which "
                         "waits for ROADMAP item C1 (remaining op "
                         "families: ops/moe.py)")


def _rope_inv_freq(hd, base):
    """(hd/2,) inverse frequencies base**(-2i/hd), as graph constants."""
    half = hd // 2
    idx = sym.arange(start=0, stop=half)
    return sym.exp(idx * (-2.0 * math.log(base) / hd))


def _rope_apply(t, cos, sin, hd):
    """Rotate (…, hd) pairs (GPT-NeoX half-split form)."""
    half = hd // 2
    t1 = sym.slice_axis(t, axis=3, begin=0, end=half)
    t2 = sym.slice_axis(t, axis=3, begin=half, end=None)
    return sym.Concat(
        sym.broadcast_mul(t1, cos) - sym.broadcast_mul(t2, sin),
        sym.broadcast_mul(t2, cos) + sym.broadcast_mul(t1, sin), dim=3)


def _attention_block(x, seq_len, d_model, num_heads, name,
                     num_kv_heads=None, causal=True, rope_cs=None):
    """x: (B, S, d) → (B, S, d): QKV projection, flash attention (causal
    by default), output projection.  ``num_kv_heads < num_heads`` is
    grouped-query attention; the kernel shares each KV head per group."""
    h = num_heads
    hk = h if num_kv_heads is None else num_kv_heads
    if hk < 1 or h % hk:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hk}")
    if d_model % h:
        raise ValueError(
            f"d_model {d_model} not divisible by num_heads {h}")
    hd = d_model // h
    flat = sym.Reshape(x, shape=(-1, d_model))
    qkv = sym.FullyConnected(flat, num_hidden=(h + 2 * hk) * hd,
                             name=f"{name}_qkv")
    q = sym.slice_axis(qkv, axis=1, begin=0, end=h * hd)
    k = sym.slice_axis(qkv, axis=1, begin=h * hd, end=(h + hk) * hd)
    v = sym.slice_axis(qkv, axis=1, begin=(h + hk) * hd,
                       end=(h + 2 * hk) * hd)

    def heads(t, nh):
        t = sym.Reshape(t, shape=(-1, seq_len, nh, hd))
        return sym.transpose(t, axes=(0, 2, 1, 3))    # (B, nh, S, hd)

    qh, kh = heads(q, h), heads(k, hk)
    if rope_cs is not None:
        cos, sin = rope_cs
        qh = _rope_apply(qh, cos, sin, hd)
        kh = _rope_apply(kh, cos, sin, hd)
    attn = sym.contrib.FlashAttention(qh, kh,
                                      heads(v, hk), causal=causal,
                                      name=f"{name}_flash")
    attn = sym.transpose(attn, axes=(0, 2, 1, 3))     # (B, S, H, hd)
    attn = sym.Reshape(attn, shape=(-1, d_model))
    out = sym.FullyConnected(attn, num_hidden=d_model,
                             name=f"{name}_proj")
    return sym.Reshape(out, shape=(-1, seq_len, d_model))


def _ffn_block(x, seq_len, d_model, d_ff, name, ffn_type="gelu"):
    flat = sym.Reshape(x, shape=(-1, d_model))
    if ffn_type == "swiglu":
        # SwiGLU: silu(xW1) * xW3 -> W2, one fused projection [gate | lin]
        both = sym.FullyConnected(flat, num_hidden=2 * d_ff,
                                  name=f"{name}_fc1")
        gate = sym.slice_axis(both, axis=1, begin=0, end=d_ff)
        lin = sym.slice_axis(both, axis=1, begin=d_ff, end=None)
        hdn = gate * sym.sigmoid(gate) * lin
        out = sym.FullyConnected(hdn, num_hidden=d_model,
                                 name=f"{name}_fc2")
        return sym.Reshape(out, shape=(-1, seq_len, d_model))
    if ffn_type != "gelu":
        raise ValueError(f"ffn_type must be gelu|swiglu, got {ffn_type!r}")
    hdn = sym.FullyConnected(flat, num_hidden=d_ff, name=f"{name}_fc1")
    hdn = hdn * sym.sigmoid(hdn * 1.702)   # gelu (sigmoid approx)
    out = sym.FullyConnected(hdn, num_hidden=d_model, name=f"{name}_fc2")
    return sym.Reshape(out, shape=(-1, seq_len, d_model))


def transformer_lm(vocab_size, seq_len, num_layers=2, d_model=128,
                   num_heads=4, num_kv_heads=None, d_ff=None,
                   moe_experts=0, moe_k=1, max_len=None,
                   pos_type="learned", rope_base=10000.0,
                   ffn_type="gelu", loss_type="softmax", ce_chunks=8):
    """Causal LM symbol: data (B, S) token ids, softmax_label (B, S);
    the output is the (B*S, vocab) softmax.

    ``max_len`` (default seq_len) sizes the positional embedding.  The
    MoE FFN (``moe_experts > 0``) and the chunked loss head
    (``loss_type="chunked_ce"``) are not ported yet and raise."""
    _check_moe("transformer_lm", moe_experts)
    if loss_type == "chunked_ce":
        raise MXNetError("transformer_lm: loss_type='chunked_ce' needs the "
                         "chunked LM loss, which waits for ROADMAP item T1 "
                         "(the training slice: ops/chunked_loss.py)")
    if loss_type != "softmax":
        raise ValueError(
            f"loss_type must be softmax|chunked_ce, got {loss_type!r}")
    d_ff = d_ff or 4 * d_model
    max_len = max_len or seq_len
    if max_len < seq_len:
        raise ValueError(
            f"transformer_lm: max_len ({max_len}) must be >= seq_len "
            f"({seq_len}) — pass the largest bucket as max_len")
    if pos_type not in ("learned", "rope"):
        raise ValueError(f"pos_type must be learned|rope, got {pos_type!r}")
    data = sym.Variable("data")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                      name="tok_embed")
    if pos_type == "learned":
        pos = sym.Variable("pos_embed_weight", shape=(max_len, d_model))
        pos = sym.slice_axis(pos, axis=0, begin=0, end=seq_len)
        x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0))
    rope_cs = None
    if pos_type == "rope":
        hd_ = d_model // num_heads
        if hd_ % 2:
            raise ValueError(f"rope needs even head_dim, got {hd_}")
        # one angle table shared by every layer: (1, 1, S, hd/2)
        ang = sym.broadcast_mul(
            sym.Reshape(sym.arange(start=0, stop=seq_len),
                        shape=(1, 1, seq_len, 1)),
            sym.Reshape(_rope_inv_freq(hd_, rope_base),
                        shape=(1, 1, 1, hd_ // 2)))
        rope_cs = (sym.cos(ang), sym.sin(ang))
    for i in range(num_layers):
        name = f"layer{i}"
        a = _attention_block(sym.LayerNorm(x, name=f"{name}_ln1"),
                             seq_len, d_model, num_heads, name,
                             num_kv_heads=num_kv_heads,
                             rope_cs=rope_cs)
        x = x + a
        f = _ffn_block(sym.LayerNorm(x, name=f"{name}_ln2"),
                       seq_len, d_model, d_ff, name, ffn_type=ffn_type)
        x = x + f
    x = sym.LayerNorm(x, name="final_ln")
    hidden = sym.Reshape(x, shape=(-1, d_model))
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    logits = sym.FullyConnected(hidden, num_hidden=vocab_size,
                                name="lm_head")
    return sym.SoftmaxOutput(data=logits, label=label, name="softmax")



def transformer_decode_step(vocab_size, max_len, batch_size,
                            num_layers=2, d_model=128,
                            num_heads=4, num_kv_heads=None, d_ff=None,
                            moe_experts=0, moe_k=1,
                            pos_type="learned", rope_base=10000.0,
                            ffn_type="gelu"):
    """One autoregressive decode step with a rolled KV cache.

    Parameter names equal ``transformer_lm``'s, so an LM's weights load
    straight into it.  The cache is carried through ``Module``
    ``state_names`` (``set_states`` / ``get_states``): per layer
    ``layer{i}_k_cache`` / ``layer{i}_v_cache`` of shape (batch_size,
    kv_heads, max_len, head_dim), plus ``cur_pos`` (B,), the float
    position.  The cache rolls left one slot a step (static shapes); the
    slots still empty are masked by comparing their index with cur_pos.

    Generation length is bounded by ``max_len``.  With learned positions,
    decoding past max_len clamps to the last position (Embedding clips);
    with rope the rolled cache becomes a sliding window past max_len.

    Inputs: data (B,) current token ids.  Outputs: [logits (B, vocab)] +
    [new k / v caches per layer] + [cur_pos + 1].  Under a bf16
    ``compute_dtype`` the ``cur_pos + 1`` add runs in bf16, as in the JAX
    package, so the counter stops at 256 (ROADMAP §3): decode in fp32.
    The MoE FFN (``moe_experts > 0``) is not ported yet and raises.
    """
    _check_moe("transformer_decode_step", moe_experts)
    d_ff = d_ff or 4 * d_model
    h = num_heads
    hk = h if num_kv_heads is None else num_kv_heads
    if hk < 1 or h % hk:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hk}")
    hd = d_model // h
    g = h // hk

    B = int(batch_size)   # the cache's shape pins the batch
    data = sym.Variable("data")                  # (B,) token ids
    pos = sym.Variable("cur_pos", shape=(B,))    # float position
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                      name="tok_embed")          # (B, d)
    if pos_type == "learned":
        pos_w = sym.Variable("pos_embed_weight", shape=(max_len, d_model))
        pv = sym.Embedding(pos, weight=pos_w, input_dim=max_len,
                           output_dim=d_model, name="pos_lookup")
        x = x + pv
    elif pos_type != "rope":
        raise ValueError(f"pos_type must be learned|rope, got {pos_type!r}")
    if pos_type == "rope":
        if hd % 2:
            raise ValueError(f"rope needs even head_dim, got {hd}")
        # the angles of the current position, per row: (B, 1, 1, hd/2);
        # cached keys were rotated at their own positions when inserted
        rope_ang = sym.broadcast_mul(
            sym.Reshape(pos, shape=(-1, 1, 1, 1)),
            sym.Reshape(_rope_inv_freq(hd, rope_base),
                        shape=(1, 1, 1, hd // 2)))
        rope_cos, rope_sin = sym.cos(rope_ang), sym.sin(rope_ang)

    # cache slot i holds the token at position cur_pos - (L - 1 - i); it is
    # valid iff i >= max_len - 1 - cur_pos (the current token lands in the
    # last slot this step)
    slot = sym.Reshape(sym.arange(start=0, stop=max_len),
                       shape=(1, max_len))
    valid = sym.broadcast_greater_equal(
        slot, sym.Reshape(float(max_len) - 1.0 - pos, shape=(-1, 1)))
    new_states = []
    scale = 1.0 / (hd ** 0.5)
    for i in range(num_layers):
        name = f"layer{i}"
        xin = sym.LayerNorm(x, name=f"{name}_ln1")
        qkv = sym.FullyConnected(xin, num_hidden=(h + 2 * hk) * hd,
                                 name=f"{name}_qkv")
        q = sym.Reshape(sym.slice_axis(qkv, axis=1, begin=0, end=h * hd),
                        shape=(-1, h, 1, hd))
        kn = sym.Reshape(sym.slice_axis(qkv, axis=1, begin=h * hd,
                                        end=(h + hk) * hd),
                         shape=(-1, hk, 1, hd))
        vn = sym.Reshape(sym.slice_axis(qkv, axis=1, begin=(h + hk) * hd,
                                        end=(h + 2 * hk) * hd),
                         shape=(-1, hk, 1, hd))
        if pos_type == "rope":
            q = _rope_apply(q, rope_cos, rope_sin, hd)
            kn = _rope_apply(kn, rope_cos, rope_sin, hd)
        kc = sym.Variable(f"{name}_k_cache", shape=(B, hk, max_len, hd))
        vc = sym.Variable(f"{name}_v_cache", shape=(B, hk, max_len, hd))
        kc2 = sym.Concat(sym.slice_axis(kc, axis=2, begin=1, end=None),
                         kn, dim=2, name=f"{name}_kroll")
        vc2 = sym.Concat(sym.slice_axis(vc, axis=2, begin=1, end=None),
                         vn, dim=2, name=f"{name}_vroll")
        new_states += [kc2, vc2]
        # GQA: each cached kv head repeated for its query group
        kr = sym.repeat(kc2, repeats=g, axis=1) if g > 1 else kc2
        vr = sym.repeat(vc2, repeats=g, axis=1) if g > 1 else vc2
        # scores (B*h, 1, max_len) = q . k^T
        qf = sym.Reshape(q, shape=(-3, 1, hd))
        kf = sym.Reshape(kr, shape=(-3, max_len, hd))
        s = sym.batch_dot(qf, sym.swapaxes(kf, dim1=1, dim2=2)) * scale
        s = sym.Reshape(s, shape=(-4, -1, h, max_len))
        # additive mask: 0 on real slots, -1e30 on empty ones
        mask = sym.Reshape((valid - 1.0) * 1e30,
                           shape=(-4, -1, 1, max_len))
        s = sym.broadcast_add(s, mask)
        p = sym.softmax(s, axis=-1)
        pf = sym.Reshape(p, shape=(-3, 1, max_len))
        vf = sym.Reshape(vr, shape=(-3, max_len, hd))
        o = sym.batch_dot(pf, vf)                     # (B*h, 1, hd)
        o = sym.Reshape(o, shape=(-4, -1, h, hd))
        o = sym.Reshape(o, shape=(-1, d_model))
        a = sym.FullyConnected(o, num_hidden=d_model, name=f"{name}_proj")
        x = x + a
        f = _ffn_block(sym.expand_dims(
            sym.LayerNorm(x, name=f"{name}_ln2"), axis=1),
            1, d_model, d_ff, name, ffn_type=ffn_type)
        x = x + sym.Reshape(f, shape=(-1, d_model))
    x = sym.LayerNorm(x, name="final_ln")
    logits = sym.FullyConnected(x, num_hidden=vocab_size, name="lm_head")
    new_states.append(pos + 1.0)
    return sym.Group([logits] + new_states)
