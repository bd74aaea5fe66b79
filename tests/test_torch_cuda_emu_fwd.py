"""The float32 flash-attention forward kernel (``csrc/flash_fwd.cu``
``flash_fwd_kernel``, K1's f32 instance) run on the CPU under the
emulation of the CUDA runtime in ``tests/cuda_emu/`` (one fiber per
CUDA thread, barriers for ``__syncthreads``,
``__syncwarp`` and the warp shuffles, ``cp.async`` copies landing when
they start or only at the wait that must cover them).

It checks the kernel's indexing, masks (causal, ragged Sq and Sk, GQA
and MQA, one row), the online softmax across tiles, the copy ring's
waits and barriers, the four warps' split of the keys and the merge of
their states (the small-grid design), and the rule that picks it from
the card's SM count, against the port's plain attention
(``_attn_reference``, itself held against the JAX package in
``test_torch_attention.py``) within 1e-5 (both sum in f32 in other
orders, the kernel takes exp as exp2; measured about 1e-6 here), the lse
output too, and that a launch without lse gives the same bits as one
with it.  The outputs start as NaN, so an element no thread writes
shows.  What it cannot: what nvcc makes of the source, the card's
arithmetic, races the host's memory model hides, or speed
(``chip_smoke.py``).  Skips without a host C++ compiler."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emu.build import build
from mxnet_tpu_torch.ops import attention as att
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = 1e-5

# B, H, Hk, Sq, Sk, D, causal: both sides of the 64-row tile edges, GQA
# and MQA, Sq != Sk both ways under causal, one row, D 32 / 64 / 128
CASES = [
    (1, 2, 2, 48, 48, 32, False),
    (1, 4, 2, 37, 37, 64, True),
    (1, 4, 1, 130, 130, 32, True),
    (1, 2, 2, 100, 300, 64, True),
    (1, 2, 2, 300, 100, 64, True),
    (1, 2, 1, 1, 1, 64, True),
    (1, 2, 2, 77, 130, 64, False),
    (1, 2, 1, 130, 77, 128, True),
    (1, 2, 2, 80, 80, 64, True),
    (1, 2, 1, 80, 144, 128, False),
    (2, 2, 2, 33, 97, 32, True),
    (1, 2, 2, 196, 196, 64, False),
]
IDS = ["B{}H{}Hk{}Sq{}Sk{}D{}{}".format(*c[:6], "c" if c[6] else "")
       for c in CASES]
# q rows a block: 64, or 16 (the block's four warps splitting the keys)
# when the grid of 64-row tiles leaves SMs without a block
TILES = (64, 16)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("flash_fwd.cu", str(tmp_path_factory.mktemp("emu_fwd")),
                launches=2, extern_shared=2)
    lib.mxtt_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.mxtt_flash_fwd_f32_tile.argtypes = [ctypes.c_int] * 4
    return lib


def _launch(lib, q, k, v, causal, scale, with_lse):
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    out = torch.full_like(q, float("nan"))
    lse = torch.full((B, H, Sq), float("nan")) if with_lse else None
    err = lib.mxtt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if with_lse else None, B, H, Hk,
                             Sq, Sk, D, 0, int(causal), scale, 0, None)
    assert err == 0
    return out, lse


@pytest.mark.parametrize("defer", [0, 1], ids=["copies_at_start",
                                               "copies_at_wait"])
@pytest.mark.parametrize("tile", TILES, ids=[f"q{t}" for t in TILES])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_f32_forward_kernel_matches_plain_version(lib, case, tile, defer):
    B, H, Hk, Sq, Sk, D, causal = case
    ctypes.c_int.in_dll(lib, "emu_sm_count").value = 1 if tile == 64 \
        else 1 << 30
    assert lib.mxtt_flash_fwd_f32_tile(B, H, Sq, 0) == tile
    ctypes.c_int.in_dll(lib, "emu_defer").value = defer
    rng = np.random.default_rng(CASES.index(case))

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    q, k, v = mk(B, H, Sq, D), mk(B, Hk, Sk, D), mk(B, Hk, Sk, D)
    out, lse = _launch(lib, q, k, v, causal, D ** -0.5, True)
    bare, _ = _launch(lib, q, k, v, causal, D ** -0.5, False)
    ref, ref_lse = att._attn_reference(q, k, v, causal, None,
                                       return_lse=True)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    assert torch.equal(out, bare), "without lse the output differs"


def test_small_grid_rule_at_the_main_paths_shapes(lib):
    """On 132 SMs: the main shape (B 8, H 12, S 1024: 1536 blocks of 64
    rows) keeps 64-row tiles; ViT-S/16's fp32 predict (B 2, H 6, S 196: 48
    blocks of 64 rows) splits the keys over 156 blocks of 16 rows."""
    ctypes.c_int.in_dll(lib, "emu_sm_count").value = 132
    assert lib.mxtt_flash_fwd_f32_tile(8, 12, 1024, 0) == 64
    assert lib.mxtt_flash_fwd_f32_tile(2, 6, 196, 0) == 16
    assert lib.mxtt_flash_fwd_f32_tile(11, 3, 256, 0) == 64
    assert lib.mxtt_flash_fwd_f32_tile(1, 1, 1, 0) == 16
