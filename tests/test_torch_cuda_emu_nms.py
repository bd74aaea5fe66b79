"""The NMS suppression-matrix kernel (``csrc/nms_overlap.cu``
``nms_suppress_kernel``, N1) run on the CPU under the emulation of the
CUDA runtime in ``tests/cuda_emu/``, against its plain version
(``detection.suppress_matrix_plain``) bit for bit.

The emulation computes in IEEE single precision without contraction and
rounds to bfloat16 to nearest even, as the card and PyTorch's CPU
kernels do, so the kernel's matrix must equal the plain version's on the
CPU exactly: both overlap rules, bf16 and f32 boxes, with and without
classes (a warp's rows with few candidates share them out across the
warp, rows with many take all 16 IoUs a lane), ``ks`` below ``ke``,
invalid rows, a single box, every box invalid, ragged row ends (``ke``
not a multiple of 16, the padded row stride) and blocks whose i's all
lie below their rows.  The output starts as 0xAB bytes, so a byte no
thread writes shows.  What it cannot: what nvcc makes of the source, or
speed (``chip_smoke.py``).  Skips without a host C++ compiler."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emu.build import build
from mxnet_tpu_torch.ops import detection
import torch_threads  # noqa: F401,E402  a worker's share of the cores

# images, boxes K, ks, ke, dtype, rule, thresh, classes, invalid share
CASES = {
    "corner_bf16_classes": (2, 300, 300, 300, "bfloat16", "corner", 0.5,
                            True, 0.05),
    "corner_fp32_classes": (2, 300, 300, 300, "float32", "corner", 0.5,
                            True, 0.05),
    "pixel_fp32": (1, 150, 150, 150, "float32", "pixel", 0.7, False, 0.0),
    "pixel_bf16": (1, 150, 150, 150, "bfloat16", "pixel", 0.7, False, 0.0),
    # ks < ke < K, the rows past ks absent, ke off the 16-byte stride
    "topk_rows": (2, 200, 37, 181, "float32", "corner", 0.45, True, 0.2),
    # i's of two blocks of 2048, the first all below the last rows
    "two_blocks": (1, 2100, 2100, 2100, "float32", "corner", 0.5, True,
                   0.05),
    # the last rows' block (j from 128) meets the last i (129) only on
    # its first row
    "last_row_block": (1, 130, 130, 130, "float32", "corner", 0.3, False,
                       0.0),
    "single_box": (1, 1, 1, 1, "float32", "corner", 0.5, True, 0.0),
    "row_of_a_multiple_of_4": (2, 196, 196, 196, "bfloat16", "corner", 0.5,
                               True, 0.05),
    "row_of_a_multiple_of_16": (1, 160, 160, 160, "float32", "pixel", 0.7,
                                False, 0.0),
    "all_invalid": (2, 40, 40, 40, "bfloat16", "corner", 0.5, True, 1.0),
    # no classes: a warp's first rows have 128 candidates and more (all 16
    # IoUs a lane), its later rows and the second warp's fewer (shared out)
    "dense_and_shared_rows": (1, 600, 600, 600, "float32", "corner", 0.5,
                              False, 0.0),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("nms_overlap.cu", str(tmp_path_factory.mktemp("emu_nms")),
                launches=2, extern_shared=0)
    lib.mxtt_nms_suppress.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def _inputs(n, K, dtype, rule, classes, invalid, seed):
    """Boxes in clusters of 8, so that many pairs lie near the threshold
    (the card check's generator, in numpy); pixel boxes on 800 x 600."""
    rng = np.random.default_rng(seed)
    centre = np.repeat(rng.random((n, K // 8 + 1, 2)), 8, axis=1)[:, :K]
    centre = centre + (rng.random((n, K, 2)) - 0.5) * 0.06
    half = (0.05 + rng.random((n, K, 2)) * 0.35) / 2
    boxes = np.clip(np.concatenate([centre - half, centre + half], -1), 0, 1)
    if rule == "pixel":
        boxes = np.round(boxes * np.array([800., 600., 800., 600.]))
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(
        getattr(torch, dtype))
    valid = torch.from_numpy(rng.random((n, K)) >= invalid)
    cls = torch.from_numpy(np.floor(rng.random((n, K)) * 20).astype(
        np.float32)) if classes else None
    return boxes, valid, cls


def _kernel(lib, boxes, valid, cls, ks, ke, thresh, rule):
    n, K = valid.shape
    ld = -(-ke // 16) * 16
    S = torch.full((n, ks, ld), 0xAB, dtype=torch.uint8)
    err = lib.mxtt_nms_suppress(
        boxes.data_ptr(), valid.data_ptr(),
        cls.data_ptr() if cls is not None else None, S.data_ptr(), n, K, ks,
        ke, ld, 0 if boxes.dtype == torch.float32 else 1,
        0 if rule == "corner" else 1, thresh, 0, None)
    assert err == 0
    assert bool((S[..., ke:] == 0).all()), "the padding is not zeros"
    return S[..., :ke]


@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_kernel_equals_plain_version_bit_for_bit(lib, case):
    n, K, ks, ke, dtype, rule, thresh, classes, invalid = CASES[case]
    boxes, valid, cls = _inputs(n, K, dtype, rule, classes, invalid,
                                sorted(CASES).index(case))
    overlap = detection.iou_matrix if rule == "corner" \
        else detection.pixel_iou
    thresh = detection._w(thresh, boxes)
    want = detection.suppress_matrix_plain(boxes, valid, cls, ks, ke,
                                           thresh, overlap)
    got = _kernel(lib, boxes, valid, cls, ks, ke, thresh, rule)
    again = _kernel(lib, boxes, valid, cls, ks, ke, thresh, rule)
    assert got.dtype == torch.uint8 and set(got.unique().tolist()) <= {0, 1}
    mism = int((got.bool() != want).sum())
    assert mism == 0, f"{mism} of {want.numel()} pairs differ"
    assert torch.equal(got, again)
    if case not in ("all_invalid", "single_box"):
        assert int(want.sum()) > 0, "no suppressing pair: a weak case"


def _near_threshold_boxes(dtype, rule, thresh, n_a=40, seed=0):
    """Pairs of boxes one box high, the second nested in the first: A wide
    and B wide, B each of the 7 values of the dtype nearest thresh * A, so
    that the pair's IoU, about B / A, lies within a few ulps of thresh
    and many of them round on either side of it."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if rule == "corner" else 100.0
    A = torch.from_numpy((rng.uniform(1.0, 1.9, n_a) * scale).astype(
        np.float32)).to(getattr(torch, dtype))
    B0 = (A.float() * thresh).to(A.dtype)
    bits = torch.int32 if dtype == "float32" else torch.int16
    B = torch.stack([(B0.view(bits) + k).view(A.dtype) for k in range(-3, 4)],
                    1)
    A = A[:, None].expand_as(B)
    widths = torch.stack([A, B], -1).reshape(-1).float()
    zero = torch.zeros_like(widths)
    if rule == "corner":
        boxes = torch.stack([zero, zero, widths, zero + 1], -1)
    else:  # pixel boxes: x1 - x0 + 1 wide, y1 - y0 + 1 high
        boxes = torch.stack([zero, zero, widths - 1, zero], -1)
    boxes = boxes[None].to(A.dtype)
    return boxes, torch.ones(boxes.shape[:2], dtype=torch.bool)


# (dtype, rule, threshold): even and odd last bits (0.5, 0.7; in bf16
# 0.5 and 0.69921875), a threshold of neither kind (bf16 boxes with a
# threshold that is no bf16 value, and 0) that takes the division
NEAR = [("float32", "corner", 0.5), ("float32", "corner", 0.7),
        ("float32", "pixel", 0.7), ("bfloat16", "corner", 0.5),
        ("bfloat16", "corner", 0.7), ("bfloat16", "pixel", 0.5),
        ("bfloat16", "corner", 0.6999), ("float32", "corner", 0.0)]


@pytest.mark.parametrize("dtype,rule,thresh", NEAR,
                         ids=[f"{d}-{r}-{t}" for d, r, t in NEAR])
def test_nms_kernel_rounds_quotients_at_the_threshold_as_plain(
        lib, dtype, rule, thresh):
    """The kernel decides round(inter / union) > thresh without dividing
    where its bounds are exact; quotients within an ulp of the threshold
    must still land on the plain version's side of it.  In f32 some of
    these quotients lie between thresh and the midpoint to the next float
    (a bound at thresh itself fails here); an exact tie at the midpoint
    cannot occur (it needs a 25-bit numerator), nor, in bf16, a quotient
    of two 8-bit values within an f32 ulp of a bf16 midpoint, so those
    parts of the bounds are held by their derivation, not by a case."""
    boxes, valid = _near_threshold_boxes(dtype, rule, thresh)
    overlap = detection.iou_matrix if rule == "corner" \
        else detection.pixel_iou
    if thresh != 0.6999:
        thresh = detection._w(thresh, boxes)
    K = valid.shape[1]
    want = detection.suppress_matrix_plain(boxes, valid, None, K, K,
                                           thresh, overlap)
    got = _kernel(lib, boxes, valid, None, K, K, thresh, rule)
    mism = int((got.bool() != want).sum())
    assert mism == 0, f"{mism} of {want.numel()} pairs differ"
    # the probes (box 2 p against box 2 p + 1) fall on both sides
    probes = want[0, torch.arange(0, K, 2), torch.arange(1, K, 2)]
    assert 0 < int(probes.sum()) < probes.numel()
