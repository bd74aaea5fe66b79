"""Build and load the package's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The build
happens at first use, from the sources in the checkout, into
``build/kernels/<stem>-<hash>/`` beside the package; the hash covers the
source text, every header under ``csrc/`` (``*.cuh``) and the compiler
flags, so an edited source or header rebuilds.
Importing this module builds nothing and creates no CUDA context.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them, so the build takes as long as the slowest source.
``ptxas_report`` and ``hmma_counts`` read what was built: registers and
spills per kernel from the ``-Xptxas -v`` log, and how many ``HMMA``
instructions (tensor-core products) each kernel's machine code holds
(``cuobjdump -sass``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from .base import MXNetError

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# sources, in build order; each becomes lib<stem>.so
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "nms_overlap.cu")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on ``PATH``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin and PATH): the CUDA kernels "
                     "cannot be built")


def _lib_path(source: str) -> str:
    """Where ``source``'s library goes: keyed by the source, every header
    of ``csrc/`` (a source may include any of them) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(b"\0" + name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}",
                        f"lib{stem}.so")


def build_all(sources=SOURCES) -> Dict[str, dict]:
    """Build every source that is not built yet, all ``nvcc`` processes
    started together.  Returns ``{source: {"path", "seconds", "log"}}``;
    ``log`` holds nvcc's output (``-Xptxas -v`` register and
    shared-memory report) for sources built by this call."""
    out: Dict[str, dict] = {}
    procs: List[tuple] = []
    nvcc = None
    for src in sources:
        path = _lib_path(src)
        if os.path.exists(path):
            out[src] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or find_nvcc()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((src, path, tmp, p, time.monotonic()))
    failed = []
    for src, path, tmp, p, t0 in procs:
        log, _ = p.communicate()
        secs = time.monotonic() - t0
        if p.returncode != 0:
            failed.append(f"{src}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        with open(path + ".log", "w") as f:
            f.write(log)
        out[src] = {"path": path, "seconds": secs, "log": log}
    if failed:
        raise MXNetError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = build_all((source,))[source]["path"]
            lib = _libs[source] = ctypes.CDLL(path)
        return lib


def ptxas_report(log: str) -> Dict[str, dict]:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from
    nvcc's ``-Xptxas -v`` output (mangled kernel names)."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def hmma_counts(sass: str) -> Dict[str, int]:
    """``{kernel: n}``: how many HMMA instructions (tensor-core products)
    each function of a ``cuobjdump -sass`` listing holds (mangled
    names)."""
    out: Dict[str, int] = {}
    cur = None
    pat = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?HMMA\b")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, 0)
        elif cur is not None and pat.match(line):
            out[cur] += 1
    return out


def disassemble(path: str) -> str:
    """``cuobjdump -sass`` of a built library (the tool beside nvcc)."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise MXNetError(f"cuobjdump failed on {path}: {res.stderr}")
    return res.stdout
