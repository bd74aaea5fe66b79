"""Card-only tests of the NMS suppression-matrix kernel
(``mxnet_tpu_torch/csrc/nms_overlap.cu``) against its plain version.
They need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip without
one.  This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_nms.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rule", ["corner", "pixel"])
def test_nms_suppress_kernel_matches_plain_version(dev, dtype, rule):
    """csrc/nms_overlap.cu against suppress_matrix's plain version on the
    card, bit for bit (the kernel rounds each operation as PyTorch's
    elementwise kernels do), with and without classes and a top-k cut,
    and MultiBoxDetection on the card against the CPU."""
    from mxnet_tpu_torch.ops import detection
    rng = np.random.default_rng(3)
    n, k = 3, 300
    centre = rng.uniform(0, 1, (n, k // 6 + 1, 1, 2)).repeat(6, 2)
    centre = centre.reshape(n, -1, 2)[:, :k] + rng.normal(0, 0.02, (n, k, 2))
    half = rng.uniform(0.03, 0.2, (n, k, 2))
    boxes = np.concatenate([centre - half, centre + half], -1).clip(0, 1)
    if rule == "pixel":
        boxes = np.round(boxes * 500)
    overlap = detection.iou_matrix if rule == "corner" \
        else detection.pixel_iou
    b = torch.from_numpy(boxes.astype(np.float32)).to(dev, dtype)
    valid = torch.from_numpy(rng.random((n, k)) > 0.1).to(dev)
    cls = torch.from_numpy(rng.integers(0, 4, (n, k)).astype(np.float32)) \
        .to(dev)
    thresh = detection._w(0.5, b)
    before = detection.suppress_matrix_cuda.launches
    for classes in (cls, None):
        for ks in (k, 100):
            args = (b, valid, classes, ks, k, thresh, overlap)
            got = detection.suppress_matrix_cuda(*args)
            want = detection.suppress_matrix_plain(*args)
            assert tuple(got.shape) == (n, ks, 304)  # rows of 16 bytes
            assert torch.equal(got[..., :k], want), (classes is None, ks)
            assert not got[..., k:].any()
    assert detection.suppress_matrix_cuda.launches == before + 4
    if rule == "corner" and dtype == torch.float32:
        logits = rng.standard_normal((n, 5, k)).astype(np.float32)
        prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        loc = (rng.standard_normal((n, 4 * k)) * 0.2).astype(np.float32)
        anchors = boxes[:1].astype(np.float32)
        det = mt.ops.registry.get("_contrib_MultiBoxDetection").fn
        cpu = det(*[torch.from_numpy(a) for a in (prob, loc, anchors)])
        gpu = det(*[torch.from_numpy(a).to(dev)
                    for a in (prob, loc, anchors)]).cpu()
        assert torch.equal(gpu[..., 0], cpu[..., 0])
        assert float((gpu - cpu).abs().max()) <= 1e-6


def test_nms_suppress_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.ops import detection
    b = torch.zeros(1, 8, 4, device=dev, dtype=torch.float16)
    v = torch.ones(1, 8, dtype=torch.bool, device=dev)
    with pytest.raises(mt.MXNetError):
        detection.suppress_matrix_cuda(b, v, None, 8, 8, 0.5,
                                       detection.iou_matrix)
    with pytest.raises(mt.MXNetError):
        detection.suppress_matrix_cuda(b.float(), v, None, 8, 8, 0.5,
                                       lambda a, c: a)
