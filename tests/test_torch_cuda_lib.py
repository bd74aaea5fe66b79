"""The port's kernel build cache and build reports, on the CPU (no nvcc).

``cuda_lib`` keys each built library by its source, every ``csrc/*.cuh``
header and the compiler flags, so that an edit to a header the sources
include rebuilds them; and it reads the ``-Xptxas -v`` log and the
``cuobjdump -sass`` listing that ``chip_smoke.py`` checks (registers,
spills, tensor-core ``HMMA`` instructions per kernel).
"""
import os
import shutil

import pytest
import torch

from mxnet_tpu_torch import MXNetError, cuda_lib
from mxnet_tpu_torch.ops import attention as att


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the cache key reads instead."""
    d = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, d)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(d))
    return d


def _paths():
    return {src: cuda_lib._lib_path(src) for src in cuda_lib.SOURCES}


def test_unchanged_sources_keep_their_library(csrc):
    first = _paths()
    assert first == _paths()
    for src, path in first.items():
        stem = os.path.splitext(src)[0]
        assert os.path.dirname(os.path.dirname(path)) == cuda_lib.BUILD_DIR
        assert os.path.basename(path) == f"lib{stem}.so"
    assert len(set(first.values())) == len(first)


def test_header_edit_rebuilds_every_source(csrc):
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert headers, "the kernels share their mma helpers through a header"
    before = _paths()
    with open(csrc / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert all(after[s] != before[s] for s in cuda_lib.SOURCES)


def test_new_header_rebuilds(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(p != before[s] for s, p in _paths().items())


def test_source_edit_rebuilds_only_that_source(csrc):
    before = _paths()
    with open(csrc / "flash_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert after["flash_fwd.cu"] != before["flash_fwd.cu"]
    assert after["flash_bwd.cu"] == before["flash_bwd.cu"]


def test_flags_are_part_of_the_key(csrc, monkeypatch):
    before = _paths()
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ["-G"])
    assert all(p != before[s] for s, p in _paths().items())


def test_sources_include_the_tensor_core_header():
    with open(os.path.join(cuda_lib.CSRC_DIR, "mma_tiles.cuh")) as f:
        header = f.read()
    for instr in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                  "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                  "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                  "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert instr in header, instr
    for src, kernel in (("flash_fwd.cu", "flash_fwd_mma_kernel"),
                        ("flash_bwd.cu", "flash_bwd_dq_mma_kernel"),
                        ("flash_bwd.cu", "flash_bwd_dkv_mma_kernel")):
        with open(os.path.join(cuda_lib.CSRC_DIR, src)) as f:
            text = f.read()
        assert '#include "mma_tiles.cuh"' in text and kernel in text


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiiiiif
    24 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = cuda_lib.ptxas_report(PTXAS_LOG)
    mma = [n for n in rep if "flash_fwd_mma_kernelILi64E" in n]
    f32 = [n for n in rep if "flash_fwd_kernelIfLi128E" in n]
    assert len(rep) == 2 and len(mma) == 1 and len(f32) == 1
    assert rep[mma[0]] == dict(registers=128, spill_stores=0, spill_loads=0)
    assert rep[f32[0]] == dict(registers=255, spill_stores=16,
                               spill_loads=12)
    assert cuda_lib.ptxas_report("nvcc warning : nothing here\n") == {}


SASS = """\
Fatbin elf code:
================
arch = sm_90a
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi64EEEv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0f80*/                   HMMA.16816.F32.BF16 R24, R4, R16, R24 ;
        /*0f90*/              @!P0 HMMA.16816.F32.BF16 R28, R4, R18, R28 ;
        /*0fa0*/                   LDSM.16.M88.4 R8, [R2] ;
\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEv
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   MOV R5, 0x0 ;  /* HMMA in a comment */
"""


def test_hmma_counts_count_tensor_core_products_per_kernel():
    """Predicated HMMAs count; other opcodes and the word in a comment do
    not; a kernel without any is listed with 0."""
    hmma = cuda_lib.hmma_counts(SASS)
    assert hmma == {"_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi64EEEv": 2,
                    "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEv": 0}
    assert cuda_lib.hmma_counts("no listing\n") == {}


def test_bf16_inputs_must_start_on_16_bytes():
    """The bf16 kernels copy rows in 16-byte chunks; the wrappers refuse a
    bf16 view that starts between chunks, and do not ask it of f32."""
    flat = torch.zeros(2 * 16 * 64 + 8, dtype=torch.bfloat16)
    good = flat[8:].view(1, 2, 16, 64)
    bad = flat[1:1 + 2 * 16 * 64].view(1, 2, 16, 64)
    assert good.data_ptr() % 16 == 0 and bad.data_ptr() % 16
    att._check_aligned("k", [("q", good)])
    with pytest.raises(MXNetError, match="q does not start on a 16-byte"):
        att._check_aligned("k", [("q", good), ("q", bad)])
    f32 = torch.zeros(2 * 16 * 64 + 1)[1:].view(1, 2, 16, 64)
    assert f32.data_ptr() % 16
    att._check_aligned("k", [("q", f32)])


def test_backward_refuses_f32_views_off_16_bytes():
    """The f32 backward kernels copy rows in 16-byte chunks as well: the
    backward's check (every kernel dtype) refuses an f32 view 4 bytes
    into its storage and takes one on 16 bytes; the forward's does not
    ask it of f32."""
    flat = torch.zeros(2 * 16 * 64 + 4)
    good = flat[4:].view(1, 2, 16, 64)
    bad = flat[1:1 + 2 * 16 * 64].view(1, 2, 16, 64)
    assert good.data_ptr() % 16 == 0 and bad.data_ptr() % 16 == 4
    att._check_aligned("flash_bwd_cuda", [("q", good)], att._KERNEL_DTYPES)
    with pytest.raises(MXNetError, match="dout does not start on a 16-byte"):
        att._check_aligned("flash_bwd_cuda", [("q", good), ("dout", bad)],
                           att._KERNEL_DTYPES)
    att._check_aligned("flash_fwd_cuda", [("q", bad)])
