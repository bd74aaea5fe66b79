#!/usr/bin/env python3
"""Time hand-written kernels of the checkout in the working directory on
the card and print one JSON line: for comparing design variants of a
kernel, each variant in its own copy of the tree, in turns inside one
chip call (``cd <copy> && python3 <repo>/tools/chip_kernel_times.py k1
<label>``, copies A, B, B, A).

    k1 LABEL       K1's float32 forward at the main shape (B 8, H 12,
                   S 1024, causal) and at ViT-S/16's fp32 predict shape
                   (B 2 and 1, H 6, S 196): its q tile, the largest error
                   of the output and of the lse against the plain
                   version, ms by CUDA events and device ms by
                   torch.profiler, with SDPA's beside them
    nms LABEL      N1 at chip_smoke.py's NMS cases but the single box,
                   and at ``detect_bf16`` with classes drawn as
                   floor(20 u^3) (``detect_bf16_skewed``: 7.8% of the
                   pairs need an IoU, near the 7.6% of the detect
                   path's own boxes): median ms (and the fastest loop),
                   the share of pairs that need an IoU, and whether it
                   equals the plain version
    nms LABEL FILE the same, and at the inputs saved in FILE
                   (``detect_path``; ``detect_path_fp32``: its boxes
                   made f32)
    capture FILE   run chip_smoke.py's ssd_train and ssd_detect phases
                   and save to FILE the inputs of the detect path's
                   first N1 launch (4 images of sorted boxes, valid
                   flags, classes, the threshold): about 0.5 MB
    nonzero LABEL  torch.nonzero of a (4, 8108, 8108) bool matrix (0.2%
                   ones), contiguous, as the view of a (4, 8108, 8112)
                   one, and of that padded tensor
    i1 LABEL       I1 at chip_smoke.py's phase_i1_kernel shapes on
                   images made on the card (no JPEG: its time does not
                   depend on the pixels): batch 256 of 500 x 375 and
                   375 x 500 resized to 256, cropped to 224, float32
                   NCHW; 32 of them resized to 320, cropped to 299;
                   raw 256 x 256 cropped to 224, uint8 NCHW and NHWC.
                   Whether it equals the plain version, ms by CUDA
                   events, the kernel's device ms by torch.profiler,
                   the wrapper's host ms, the bytes bound
    relu LABEL     ResNet-50 v2's training step (chip_smoke.py's
                   resnet_train setup: batch 256, bf16, SGD momentum)
                   with Activation's relu as ``F.relu`` (torch's
                   gradient: g at NaN), as ``ops/elemwise.py`` ``_relu``
                   (jax.nn.relu's: 0 at NaN; R1's one pass on the card)
                   and as that Function with the plain version's two
                   passes and with torch's one pass (its host cost
                   alone), in turns A B C D D C B A in one process, 8
                   steps a turn after 3 warm-up steps: median ms

Uses the checkout's own ``chip_smoke.py`` helpers (``time_ms``,
``device_ms``, ``NMS_CASES``, ``nms_case_inputs``); needs one CUDA card.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

K1_SHAPES = {"main": (8, 12, 1024, True), "vit": (2, 6, 196, False),
             "vit_b1": (1, 6, 196, False)}


def k1_times():
    from mxnet_tpu_torch.ops import attention as att
    rng = np.random.default_rng(cs.SEED)
    out = {}
    for name, (B, H, S, causal) in K1_SHAPES.items():
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, H, S, 64), dtype=np.float32)).cuda() for _ in range(3))
        ref, ref_lse = att._attn_reference(q, k, v, causal, None,
                                           return_lse=True)
        got, lse = att.flash_fwd_cuda(q, k, v, causal, return_lse=True)

        def kern():
            return att.flash_fwd_cuda(q, k, v, causal)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal)
        out[name] = dict(
            tile=att.flash_fwd_f32_tile(B, H, S),
            err=float((got - ref).abs().max()),
            lse_err=float((lse - ref_lse).abs().max()),
            ms=cs.time_ms(kern)[0], dev=cs.device_ms(torch, kern)[0],
            sdpa_ms=cs.time_ms(sdpa)[0], sdpa_dev=cs.device_ms(torch, sdpa)[0])
    return out


def capture(path):
    """The detect path's first N1 launch's inputs, saved to ``path``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import detection
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    _, params, x = cs.phase_ssd_train(torch, mt, cs.PEAK_FLOPS["bfloat16"])
    saved, matrices = {}, detection.nms_matrices

    def keep_first(boxes, valid, thresh, overlap, classes, k_sup, k_eff):
        if not saved:
            per = max(1, detection.NMS_CHUNK_ELEMENTS // (k_sup * k_eff))
            saved.update(
                boxes=boxes[:per].cpu(), valid=valid[:per].cpu(),
                classes=None if classes is None else classes[:per].cpu(),
                ks=k_sup, ke=k_eff, thresh=float(thresh),
                rule="corner" if overlap is detection.iou_matrix
                else "pixel")
        return matrices(boxes, valid, thresh, overlap, classes, k_sup, k_eff)
    detection.nms_matrices = keep_first
    try:
        cs.phase_ssd_detect(torch, mt, params, x)
    finally:
        detection.nms_matrices = matrices
    torch.save(saved, path)
    return dict(saved={k: (list(v.shape) if torch.is_tensor(v) else v)
                       for k, v in saved.items()})


def nms_times(path=None):
    from mxnet_tpu_torch.ops import detection
    out = {}
    cases = dict(cs.NMS_CASES, detect_bf16_skewed=cs.NMS_CASES["detect_bf16"])
    if path:
        cases.update(detect_path=None, detect_path_fp32=None)
    for name, case in cases.items():
        if name.startswith("detect_path"):
            d = torch.load(path)
            boxes, valid, cls = (None if d[x] is None else d[x].cuda()
                                 for x in ("boxes", "valid", "classes"))
            if name.endswith("_fp32"):
                boxes = boxes.float()
            n, ks, k, rule = boxes.shape[0], d["ks"], d["ke"], d["rule"]
            thresh = d["thresh"]
        else:
            n, k, dtype, rule, thresh, classes, invalid = case
            if k == 1:
                continue
            boxes, valid, cls = cs.nms_case_inputs(torch, n, k, dtype, rule,
                                                   classes, invalid,
                                                   cs.SEED + 70)
            thresh, ks = detection._w(thresh, boxes), k
        if name.endswith("_skewed"):
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 71)
            cls = (torch.rand((n, k), generator=gen, device="cuda") ** 3
                   * 20).floor()
        overlap = detection.iou_matrix if rule == "corner" \
            else detection.pixel_iou
        args = (boxes, valid, cls, ks, k, thresh, overlap)
        got = detection.suppress_matrix_cuda(*args)
        equal = torch.equal(got[..., :k], detection.suppress_matrix_plain(
            *args)) and not got[..., k:].any()
        del got
        idx = torch.arange(k, device="cuda")
        cand = (idx[:ks, None] < idx[None, :k]) & valid[:, :ks, None]
        if cls is not None:
            cand &= cls[:, :ks, None] == cls[:, None, :k]
        share = float(cand.sum()) / cand.numel()
        del cand
        med, lo, _ = cs.time_ms(lambda: detection.suppress_matrix_cuda(*args),
                                iters=5)
        out[name] = dict(ms=med, ms_min=lo, candidate_share=share,
                         bit_identical=equal)
        torch.cuda.empty_cache()
    return out


def i1_times():
    from mxnet_tpu_torch.ops import image_augment as ia
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 103)
    sizes = cs.rec_specs(256, cs.SEED + 104)[0]
    imgs = [cs.rec_image(torch, dev, gen, h, w, 12.0) for h, w in sizes]
    flat = torch.cat([im.reshape(-1) for im in imgs])
    nb = np.array([im.numel() for im in imgs])
    offs = np.concatenate([[0], np.cumsum(nb)[:-1]])
    hs, ws = np.array(sizes).T
    rng = np.random.RandomState(cs.SEED + 101)
    mean = np.array([123.68, 116.779, 103.939], np.float32)
    S = cs.UINT8_STORED
    raw = torch.randint(0, 256, (256 * S * S * 3,), generator=gen,
                        device=dev, dtype=torch.uint8)
    cases = {
        "main": (ia.DecodedImages(flat, offs, hs, ws, 3), 256, 224,
                 "float32", "NCHW"),
        "ragged_299": (ia.DecodedImages(flat, offs[:32], hs[:32], ws[:32],
                                        3), 320, 299, "float32", "NCHW"),
        "uint8_nchw": (ia.DecodedImages(raw, np.arange(256) * S * S * 3,
                                        np.full(256, S), np.full(256, S), 3),
                       S, 224, "uint8", "NCHW"),
    }
    cases["uint8_nhwc"] = cases["uint8_nchw"][:3] + ("uint8", "NHWC")
    out = {}
    for name, (images, dec, crop, kind, layout) in cases.items():
        n = len(images)
        a = (rng.randint(0, dec - crop + 1, n), rng.randint(0, dec - crop + 1,
                                                             n),
             rng.rand(n) < 0.5, (dec, dec), (crop, crop))
        norm = (mean, np.ones(3, np.float32)) if kind == "float32" \
            else (None, None)

        def call():
            return ia.augment_cuda(images, *a, *norm, out=kind,
                                   layout=layout)
        same = torch.equal(call(), ia.augment_plain(images, *a, *norm,
                                                     out=kind, layout=layout))
        dev_ms = cs.device_ms(torch, call, stem="image_augment_kernel")[0]
        med, lo, hi = cs.time_ms(call)
        nbytes = ia.bound_bytes(images, *a, 4 if kind == "float32" else 1)
        out[name] = dict(bit_identical=same, ms=med, ms_min=lo, ms_max=hi,
                         device_ms=dev_ms, host_ms=cs.host_ms(torch, call),
                         bound_ms=nbytes / cs.PEAK_BYTES_PER_S * 1e3)
    return out


def relu_times():
    import torch.nn.functional as F
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import elemwise, nn

    def function(backward):
        """``_relu``'s autograd Function with another backward"""
        class Relu(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                y = F.relu(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, g):
                return backward(g, ctx.saved_tensors[0])
        return lambda x: Relu.apply(x) if x.requires_grad else F.relu(x)
    variants = {
        "torch_relu": F.relu, "r1": elemwise._relu,
        # the plain version's two passes (a comparison and a where)
        "two_pass": function(elemwise.relu_grad_plain),
        # torch's one pass (g at NaN): the Function's host cost alone
        "one_pass_function": function(
            lambda g, y: torch.ops.aten.threshold_backward(g, y, 0))}
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    B, shape = cs.RESNET_BATCH, (3, 224, 224)
    mod = cs.resnet_module(mt, mt.gpu(0), B, shape, "bfloat16", cs.SEED)
    batches = cs.resnet_batches(torch, mt, dev, B, shape, cs.SEED)
    out = {k: [] for k in variants}
    for name in list(variants) + list(variants)[::-1]:
        nn._ACTIVATIONS["relu"] = variants[name]
        ms, _ = cs.resnet_steps(mt, mod, batches, 11, torch.cuda.synchronize)
        out[name] += ms[3:]
    nn._ACTIVATIONS["relu"] = elemwise._relu
    return {k: dict(median_ms=float(np.median(v)), min_ms=min(v),
                    max_ms=max(v), steps=len(v)) for k, v in out.items()}


def nonzero_times():
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    padded = torch.rand((4, 8108, 8112), generator=gen, device="cuda") \
        < 0.002
    padded[..., 8108:] = False
    view = padded[..., :8108]
    dense = view.contiguous()
    assert torch.equal(view.nonzero(), dense.nonzero())
    return {name: cs.time_ms(lambda: t.nonzero(), iters=5)[0]
            for name, t in (("contiguous", dense), ("view", view),
                            ("padded", padded))}


def main():
    what, label = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("chip_kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    if what == "capture":
        print(json.dumps({"what": what, **capture(label)}), flush=True)
        return 0
    times = {"k1": k1_times, "nms": nms_times, "nonzero": nonzero_times,
             "i1": i1_times, "relu": relu_times}
    print(json.dumps({"what": what, "variant": label,
                      **times[what](*sys.argv[3:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
