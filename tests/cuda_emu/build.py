"""Build a CUDA source of ``mxnet_tpu_torch/csrc`` with the host C++
compiler against the emulation headers beside this file, for the CPU
tests (``tests/test_torch_cuda_emu*.py``).

Each launch ``kernel<...><<<grid, threads, smem, stream>>>(args)``
becomes ``emu_launch(kernel<...>, grid, threads, smem, stream, args)``;
the kernels' ``extern __shared__`` arrays become the emulation's globals
(``emu_state.cpp``) and a static ``__shared__`` array a function-local
static, one for every thread of the block as on the card."""
import ctypes
import os
import re
import shutil
import subprocess

import pytest

EMU = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(os.path.dirname(EMU)),
                    "mxnet_tpu_torch", "csrc")


def build(name, out_dir, launches, extern_shared):
    """Compile ``csrc/<name>`` under the emulation into ``out_dir`` and
    load it; ``launches`` and ``extern_shared`` are the counts of kernel
    launches and ``extern __shared__`` arrays the source must hold.
    Skips without a host C++ compiler with C++17."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    src, n = re.subn(r"(\w+<[^<>;]*>)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ",
                     src)
    assert n == launches, f"{n} launches in {name}, expected {launches}"
    src, n = re.subn(r"extern __shared__ __align__\(16\) (float|unsigned "
                     r"char) (\w+)\[\];", r"", src)
    assert n == extern_shared, f"{n} extern shared arrays in {name}"
    src = src.replace("__shared__", "static")
    src = src.replace("namespace {", "extern float smem_f32[];\nextern "
                      "unsigned char smem_raw[];\nnamespace {", 1)
    cpp = os.path.join(out_dir, name.replace(".cu", "_emu.cpp"))
    with open(cpp, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, "lib" + name.replace(".cu", "_emu.so"))
    res = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         f"-I{EMU}", "-o", so, cpp, os.path.join(EMU, "emu_state.cpp"),
         "-lpthread"], capture_output=True, text=True, timeout=600)
    if res.returncode and "c++17" in res.stderr:
        pytest.skip(f"{cxx} lacks C++17: {res.stderr[-300:]}")
    assert res.returncode == 0, res.stderr[-3000:]
    return ctypes.CDLL(so)
