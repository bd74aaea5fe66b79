"""Build and load the package's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The build
happens at first use, from the sources in the checkout, into
``build/kernels/<stem>-<hash>/`` beside the package; the hash covers the
source text and the compiler flags, so an edited source rebuilds.
Importing this module builds nothing and creates no CUDA context.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them, so the build takes as long as the slowest source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")

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
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        text = f.read()
    h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h[:16]}", f"lib{stem}.so")


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
