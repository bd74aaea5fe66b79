#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``mxnet_tpu_torch/csrc`` (into
``build/``), holds each against its plain PyTorch version on the card,
serves a GPT-2-small-width transformer LM (random weights from a seed)
through ``DynamicBatcher`` -> ``BucketedPredictor`` on ``cuda:0``, checks
the replies, and checks one full-width request in float32 against the
same request served on the CPU.  Every phase prints one JSON line; any
failed phase exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.

Imports nothing of JAX and nothing of the JAX package.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# GPT-2 small (Radford et al. 2019: n_layer 12, n_embd 768, n_head 12,
# n_ctx 1024) with the vocab rounded up to 50304, as in the repo's
# benchmark/transformer_bench.py
GPT2_SMALL = dict(vocab_size=50304, seq_len=1024, num_layers=12,
                  d_model=768, num_heads=12, d_ff=3072)
SEED = 0
BUCKETS = (1, 2, 4, 8)
REQUEST_ROWS = (1, 3, 2, 8, 5, 1)

# H100 SXM dense peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# tolerances, kernel vs plain version on the same inputs (both compute in
# f32; bf16 outputs may differ by the rounding of a near-tie, one bf16
# ulp is 2**-8 relative)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# replies vs a direct predict of the same rows, in log-probability: the
# padded bucket and the direct one run the bf16 products at other row
# counts, so cuBLAS may pick other kernels that round differently
REPLY_LOGP_TOL = 0.1
# card (kernel, TF32 off) vs CPU (plain path), fp32, log-probability
FP32_LOGP_TOL = 1e-3


T0 = time.monotonic()


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "t_s": time.monotonic() - T0, **kw}),
          flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, H, Hk, Sq, Sk, D, causal, dtype):
    """Least time for one attention forward on an H100 SXM: q/k/v read
    once and o written once over the memory rate, against the products
    these inputs need (causal: only the k <= q pairs) over the peak rate
    for the inputs' type."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (B * H * Sq * D * 2 + B * Hk * Sk * D * 2)
    if causal:
        pairs = sum(min(q + 1, Sk) for q in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * B * H * D * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops, nbytes


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


def phase_build(mt):
    t0 = time.monotonic()
    built = mt.cuda_lib.build_all()
    secs = time.monotonic() - t0
    ptxas = {src: [ln.strip() for ln in info["log"].splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, info in built.items()}
    emit("build", seconds=secs, sources=sorted(built), ptxas=ptxas)


def phase_kernels(torch, mt):
    """K1 against its plain version at every listed shape; time the
    main-path shape."""
    from mxnet_tpu_torch.ops import attention as att
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    cases = [
        # name, B, H, Hk, Sq, Sk, D, causal, dtype, lse
        ("main_bf16", 8, 12, 12, 1024, 1024, 64, True, "bfloat16", False),
        ("main_fp32", 8, 12, 12, 1024, 1024, 64, True, "float32", False),
        ("gqa_8to2_s300", 2, 8, 2, 300, 300, 64, True, "bfloat16", False),
        ("causal_sq100_sk300", 2, 4, 4, 100, 300, 64, True, "float32",
         False),
        ("noncausal_d128", 2, 4, 4, 200, 200, 128, False, "bfloat16",
         False),
        ("lse_gqa_d32", 2, 4, 1, 130, 130, 32, True, "float32", True),
    ]
    results, failures = {}, []
    for name, B, H, Hk, Sq, Sk, D, causal, dt, want_lse in cases:
        tdt = getattr(torch, dt)

        def mk(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev, tdt)
        q, k, v = mk(B, H, Sq, D), mk(B, Hk, Sk, D), mk(B, Hk, Sk, D)
        got = att.flash_fwd_cuda(q, k, v, causal, None, return_lse=want_lse)
        ref = att._attn_reference(q, k, v, causal, None,
                                  return_lse=want_lse)
        torch.cuda.synchronize()
        if not want_lse:
            got, ref = (got,), (ref,)
        errs = []
        for g, r, tol in zip(got, ref, (TOL[dt], LSE_TOL)):
            g, r = g.float(), r.float()
            err = (g - r).abs().max().item()
            if not torch.isfinite(g).all() or not torch.allclose(g, r, **tol):
                failures.append(f"{name}: max |kernel - plain| {err} "
                                f"beyond {tol} (or non-finite)")
            errs.append(err)
        row = dict(shape=[B, H, Hk, Sq, Sk, D], causal=causal, dtype=dt,
                   max_abs_err=errs[0], tol=TOL[dt])
        if want_lse:
            row.update(lse_max_abs_err=errs[1], lse_tol=LSE_TOL)
        if name.startswith("main"):
            bound, by, flops, nbytes = attention_bound_ms(
                B, H, Hk, Sq, Sk, D, causal, dt)
            row.update(
                kernel_ms=time_ms(
                    lambda: att.flash_fwd_cuda(q, k, v, causal, None)),
                plain_ms=time_ms(
                    lambda: att._attn_reference(q, k, v, causal, None),
                    iters=5),
                library_ms=time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=causal)),
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)
        results[name] = row
        emit("kernel_check", name=name, **row)
    if failures:
        raise RuntimeError("kernel checks failed: " + "; ".join(failures))
    return results


def gpt2_params(sym, seed):
    """Seeded random GPT-2-style weights (N(0, 0.02) matrices and
    biases, LayerNorm gamma near 1, beta near 0), as numpy."""
    S = GPT2_SMALL["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name.endswith("_gamma"):
            x += np.float32(1.0)
        params[name] = x
    return params


def log_probs(p):
    return np.log(np.maximum(p, np.float32(1e-38)))


def phase_serve(torch, mt, sym, params_np):
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.serving import BucketedPredictor, DynamicBatcher
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    ctx = mt.gpu(0)
    t0 = time.monotonic()
    args, aux = mt.params_from_numpy(
        params_np, {}, ctx, sym,
        {"data": (1, S), "softmax_label": (1, S)})
    pred = BucketedPredictor(sym, {"data": (S,), "softmax_label": (S,)},
                             args, aux, buckets=BUCKETS,
                             compute_dtype="bfloat16",
                             data_dtypes={"data": np.int32}, ctx=ctx)
    pred.warmup()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    rng = np.random.default_rng(SEED + 1)
    reqs = [{"data": rng.integers(0, V, (n, S), dtype=np.int32),
             "softmax_label": np.zeros((n, S), np.float32)}
            for n in REQUEST_ROWS]
    replies = [None] * len(reqs)
    lat = [None] * len(reqs)
    batcher = DynamicBatcher(pred)
    try:
        barrier = threading.Barrier(len(reqs))

        def client(i):
            barrier.wait()
            t = time.monotonic()
            slot = batcher.submit(reqs[i])
            if not slot.done.wait(600):
                raise RuntimeError(f"request {i} timed out")
            lat[i] = time.monotonic() - t
            replies[i] = slot.reply

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        # the main path: counts start at 0 here and are read right after
        att.flash_fwd_cuda.launches = 0
        mt.profiler.reset_dispatch_counts()
        t_start = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.monotonic() - t_start
        launches = att.flash_fwd_cuda.launches
        dispatches = mt.profiler.dispatch_counts().get("serving.predict", 0)
        batches = batcher.batches
    finally:
        batcher.stop()
    if any(r is None for r in replies):
        raise RuntimeError("a request got no reply")
    layers = GPT2_SMALL["num_layers"]
    if launches != layers * dispatches or dispatches == 0:
        raise RuntimeError(f"flash_fwd launches {launches} != {layers} x "
                           f"{dispatches} predict dispatches")
    worst, bit_equal = 0.0, 0
    for i, (req, reply) in enumerate(zip(reqs, replies)):
        status, payload = reply
        if status != "ok" or payload[0] != "result":
            raise RuntimeError(f"request {i} failed: {reply}")
        got = payload[2][0]
        n = REQUEST_ROWS[i]
        if got.shape != (n * S, V) or not np.isfinite(got).all():
            raise RuntimeError(f"request {i}: reply shape {got.shape} or "
                               "non-finite values")
        _, direct = pred.predict(req)
        diff = float(np.abs(log_probs(got) - log_probs(direct[0])).max())
        bit_equal += int(np.array_equal(got, direct[0]))
        if diff > REPLY_LOGP_TOL:
            raise RuntimeError(f"request {i}: reply differs from a direct "
                               f"predict by {diff} in log-prob")
        worst = max(worst, diff)
    tokens = sum(REQUEST_ROWS) * S
    emit("serve", model="gpt2-small-width", compute_dtype="bfloat16",
         buckets=list(BUCKETS), request_rows=list(REQUEST_ROWS),
         setup_s=setup_s, wall_s=wall, tokens=tokens,
         tokens_per_s=tokens / wall, latency_ms=[x * 1e3 for x in lat],
         batches=batches, predict_dispatches=dispatches,
         flash_fwd_launches=launches,
         reply_vs_direct_max_logp_diff=worst,
         reply_vs_direct_tol=REPLY_LOGP_TOL,
         replies_bit_equal=bit_equal)
    return launches, pred


def phase_profile(torch, pred):
    """Where one full bucket's predict goes: the device forward (host
    clock around forward + synchronize), the readback to the host, and
    the kernels the card ran in the forward (torch.profiler), by name."""
    from torch.profiler import ProfilerActivity, profile
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    n = BUCKETS[-1]
    rng = np.random.default_rng(SEED + 3)
    datas = {"data": rng.integers(0, V, (n, S), dtype=np.int32),
             "softmax_label": np.zeros((n, S), np.float32)}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pred.predict(datas)
    predict_s = time.monotonic() - t0
    t0 = time.monotonic()
    _, outs = pred.forward_chunk(datas, n)
    torch.cuda.synchronize()
    forward_s = time.monotonic() - t0
    t0 = time.monotonic()
    host = outs[0].cpu().numpy()
    readback_s = time.monotonic() - t0
    del outs, host
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, outs = pred.forward_chunk(datas, n)
        torch.cuda.synchronize()
    del outs
    kernels = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            kernels.append((ms, e.count, e.key[:90]))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    flash = sum(k[0] for k in kernels if "flash_fwd_kernel" in k[2])
    emit("profile", rows=n, tokens=n * S, predict_ms=predict_s * 1e3,
         forward_ms=forward_s * 1e3, readback_ms=readback_s * 1e3,
         readback_bytes=n * S * V * 4, device_busy_ms=busy,
         device_idle_share_of_forward=max(0.0, 1 - busy / (forward_s * 1e3)),
         flash_fwd_ms=flash,
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:10]])


def phase_fp32(torch, mt, sym, params_np):
    """One full-width request in fp32: card (kernel) against CPU (plain
    path), compared in log-probability."""
    from mxnet_tpu_torch.serving import BucketedPredictor
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    rng = np.random.default_rng(SEED + 2)
    req = {"data": rng.integers(0, V, (1, S), dtype=np.int32),
           "softmax_label": np.zeros((1, S), np.float32)}
    outs = {}
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        args, aux = mt.params_from_numpy(
            params_np, {}, ctx, sym,
            {"data": (1, S), "softmax_label": (1, S)})
        pred = BucketedPredictor(sym, {"data": (S,), "softmax_label": (S,)},
                                 args, aux, buckets=[1],
                                 data_dtypes={"data": np.int32}, ctx=ctx)
        t0 = time.monotonic()
        _, o = pred.predict(req)
        outs[name] = (o[0], time.monotonic() - t0)
        del pred, args, aux
    diff = float(np.abs(log_probs(outs["gpu"][0])
                        - log_probs(outs["cpu"][0])).max())
    if not np.isfinite(outs["gpu"][0]).all() or diff > FP32_LOGP_TOL:
        raise RuntimeError(f"fp32 card vs CPU: max log-prob diff {diff} "
                           f"beyond {FP32_LOGP_TOL}")
    emit("fp32_card_vs_cpu", max_logp_diff=diff, tol=FP32_LOGP_TOL,
         gpu_s=outs["gpu"][1], cpu_s=outs["cpu"][1])


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mxnet_tpu_torch as mt
    except ImportError as exc:
        print(f"chip_smoke: cannot import mxnet_tpu_torch ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device(torch)
    phase_build(mt)
    checks = phase_kernels(torch, mt)

    sym = mt.models.transformer_lm(**GPT2_SMALL)
    params_np = gpt2_params(sym, SEED)
    launches, pred = phase_serve(torch, mt, sym, params_np)
    phase_profile(torch, pred)
    del pred
    phase_fp32(torch, mt, sym, params_np)

    main_row = checks["main_bf16"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/attention.py:73",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "card": smi}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
