"""Probe torch.profiler's device windows on a CUDA card: do they keep every
kernel launched inside them, and where do the kernels' timestamps fall
against the host's clock at the window's edges?

Each round runs ``--iters`` launches of one elementwise kernel (a bf16
multiply over ResNet-50's largest relu, 205M values) in two windows:
``bare`` (launch at once after the window opens, leave it at once after
the synchronise, as a plain timing loop does) and ``padded`` (the host
sleeps ``--pad-ms`` after opening and before leaving).  A round prints
one JSON line: the launches each window recorded, and, in microseconds on
the host's clock (``time.time_ns``), the first kernel's start less the
moment the window opened (``lead_us``) and the moment the synchronise
returned less the last kernel's end (``tail_us``).  Both are positive when
the card's timestamps agree with the host's; a negative one is a skew,
and a kernel beyond the window's edge is one the profiler drops.

    python3 tools/profiler_window_probe.py [--seconds 90] [--iters 20]
"""
import argparse
import json
import time


def window(torch, fn, iters, pad_s):
    """(launches recorded, lead_us, tail_us) of one profiled window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_in = time.time_ns()
        if pad_s:
            time.sleep(pad_s)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        t_out = time.time_ns()
        if pad_s:
            time.sleep(pad_s)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if "elementwise" in e.name()
               and "cuda" in str(e.device_type()).lower()]
    if not kernels:
        return 0, None, None
    first = min(e.start_ns() for e in kernels)
    last = max(e.end_ns() for e in kernels)
    return len(kernels), (first - t_in) / 1e3, (t_out - last) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pad-ms", type=float, default=50.0)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    x = torch.randn((256, 256, 56, 56), device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(x)

    def fn():
        torch.mul(x, 2, out=out)

    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rnd = 0
    while time.monotonic() - t0 < a.seconds:
        row = {"round": rnd, "t_s": round(time.monotonic() - t0, 3),
               "iters": a.iters}
        for name, pad in (("bare", 0.0), ("padded", a.pad_ms / 1e3)):
            n, lead, tail = window(torch, fn, a.iters, pad)
            row[name] = {"launches": n, "lead_us": lead, "tail_us": tail}
        print(json.dumps(row), flush=True)
        rnd += 1
        time.sleep(2.0)


if __name__ == "__main__":
    main()
