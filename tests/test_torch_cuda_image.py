"""Card-only tests of the data path on the card: I1
(``mxnet_tpu_torch/csrc/image_augment.cu``) against its plain version,
and nvJPEG's encode and decode (``mxnet_tpu_torch/image/nvjpeg.py``)
through ``recordio`` and ``ImageRecordIter``.  They need an NVIDIA GPU
(the kernel and nvJPEG have no CPU mode) and skip without one.  This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_image.py -q -m cuda --noconftest
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
        pytest.skip("needs an NVIDIA GPU (I1 and nvJPEG have no CPU mode)")
    return torch.device("cuda", 0)


def _images(dev, n, seed=0, size=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i in range(n):
        h, w = size or (37 + 7 * i, 52 - 3 * i)
        base = torch.rand((1, 3, 4, 4), generator=gen, device=dev) * 200
        img = torch.nn.functional.interpolate(base, size=(h, w),
                                              mode="bilinear")[0]
        noise = torch.rand((3, h, w), generator=gen, device=dev) * 30
        out.append((img + noise).clamp(0, 255).to(torch.uint8)
                   .permute(1, 2, 0).contiguous())
    return out


@pytest.mark.parametrize("out,layout", [("float32", "NCHW"),
                                        ("uint8", "NCHW"),
                                        ("uint8", "NHWC")])
def test_i1_matches_plain_version_bit_for_bit(dev, out, layout):
    from mxnet_tpu_torch.ops import image_augment as ia
    imgs = [im.cpu().numpy() for im in _images(dev, 5)]
    imgs[3] = None
    images = ia.DecodedImages.from_arrays(imgs, device=dev)
    rng = np.random.RandomState(0)
    y0, x0 = rng.randint(-3, 10, 5), rng.randint(-3, 10, 5)
    flips = np.array([0, 1, 1, 0, 1], bool)
    args = (y0, x0, flips, (40, 44), (32, 36), [120.0, 110.0, 100.0],
            [58.0, 57.0, 56.0])
    before = ia.augment_cuda.launches
    got = ia.augment(images, *args, out=out, layout=layout)
    assert ia.augment_cuda.launches == before + 1
    want = ia.augment_plain(images, *args, out=out, layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# nvJPEG's decode against PIL's of the same bytes, mean absolute levels:
# at ImageNet's sizes the JAX tests' bound for their own decoder
# (tests/test_io_image.py:100); on small images more, since the two
# decoders' IDCT and chroma upsampling differ most at an image's edges:
# 2.70-3.46 levels at 51 x 46 on the H100 (chip_smoke.py rec_write's
# mad_vs_pil_by_size), held to 4
PIL_TOL_IMAGENET = 2.0
PIL_TOL_SMALL = 4.0


def _mad_vs_pil(got, jpg):
    import io
    from PIL import Image
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"), np.float32)
    mad = float(np.abs(got.float().cpu().numpy() - pil).mean())
    print(f"nvJPEG vs PIL at {tuple(got.shape)}: {mad:.3f} levels")
    return mad


def test_nvjpeg_encode_decode_and_the_record_iterator(dev, tmp_path):
    """Records written by the card's encoder; ``unpack_img`` on the card
    decodes a small image within PIL_TOL_SMALL and one of ImageNet's size
    within PIL_TOL_IMAGENET of PIL's decode of the same bytes; batches of
    ImageRecordIter on the card equal I1's plain version on nvJPEG's
    pixels."""
    from mxnet_tpu_torch.image import nvjpeg
    from mxnet_tpu_torch.ops import image_augment as ia
    imgs = _images(dev, 6, seed=1)
    imgs.append(_images(dev, 1, seed=2, size=(375, 500))[0])
    path = str(tmp_path / "c.rec")
    rec = mt.recordio.MXIndexedRecordIO(str(tmp_path / "c.idx"), path, "w")
    for i, im in enumerate(imgs):
        rec.write_idx(i, mt.recordio.pack_img((0, float(i), i, 0), im,
                                              quality=95))
    rec.close()
    r = mt.recordio.MXIndexedRecordIO(str(tmp_path / "c.idx"), path, "r")
    for i, tol in ((2, PIL_TOL_SMALL), (6, PIL_TOL_IMAGENET)):
        record = r.read_idx(i)
        with mt.gpu(0):
            _, back = mt.recordio.unpack_img(record)
        assert back.shape == tuple(imgs[i].shape)
        assert _mad_vs_pil(back._data, mt.recordio.unpack(record)[1]) < tol
    it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                               batch_size=3, resize=36, rand_crop=True,
                               rand_mirror=True, mean_r=120.0, seed=4)
    batch = it.next()
    data = batch.data[0]._data
    assert data.is_cuda and data.shape == (3, 3, 32, 32)
    assert it.decode_failures == 0
    jpegs = [mt.recordio.unpack(r.read_idx(i))[1] for i in range(3)]
    images, fails = nvjpeg.Decoder(dev).decode(jpegs)
    rng = np.random.RandomState(4)
    y0, x0 = rng.randint(0, 5, 3), rng.randint(0, 5, 3)
    flips = rng.rand(3) < 0.5
    want = ia.augment_plain(images, y0, x0, flips, (36, 36), (32, 32),
                            [120.0, 0.0, 0.0], [1.0, 1.0, 1.0])
    assert fails == 0 and torch.equal(data, want)
    np.testing.assert_array_equal(batch.label[0].asnumpy(), [0, 1, 2])


def _headers_only(jpg):
    """A JPEG's marker segments up to its first scan, then EOI: nvJPEG
    reads its size, but there is nothing to decode."""
    i = 2
    while jpg[i + 1] != 0xDA:                 # SOS
        i += 2 + int.from_bytes(jpg[i + 2:i + 4], "big")
    return jpg[:i] + b"\xff\xd9"


def test_nvjpeg_zero_fills_and_counts_what_it_cannot_decode(dev):
    """A buffer that is no JPEG (screened out by its header), a JPEG
    whose scan is overwritten (decodes without an error, as libjpeg's
    would) and one with no scan at all (its header reads, so it joins the
    batch call and fails it), among good ones: the images of the failed
    batch call are decoded again one by one, the slots that nothing
    decodes are zero-filled and counted (as io_native.cc:279-282
    zero-fills), the good images decode within PIL_TOL_IMAGENET of PIL's
    decode, and every image is counted under the path that decoded it."""
    from mxnet_tpu_torch.image import nvjpeg
    from mxnet_tpu_torch.ops import image_augment as ia
    imgs = _images(dev, 7, seed=3, size=(375, 500))
    jpegs = [mt.recordio.unpack(mt.recordio.pack_img((0, 0.0, i, 0), im))[1]
             for i, im in enumerate(imgs)]
    jpegs[1] = b"\xff\xd8 not a jpeg at all" * 4
    bad = bytearray(jpegs[4])
    mid = len(bad) // 2
    bad[mid:mid + 64] = b"\xff" * 64          # markers inside the scan
    jpegs[4] = bytes(bad)
    jpegs[6] = _headers_only(jpegs[6])
    dec = nvjpeg.Decoder(dev)
    assert dec.info(jpegs[1]) is None and dec.info(jpegs[6]) is not None
    # the batch call that holds image 6 (the hardware one or the GPU-
    # hybrid one, as nvJPEG takes each image) fails; its other images
    # go one by one
    on_hw = [dec.hardware and dec.info(j)[3] for j in jpegs]
    shared = [i for i in (0, 2, 3, 4, 5) if on_hw[i] == on_hw[6]]
    images, fails = dec.decode(jpegs)
    torch.cuda.synchronize()
    assert not images.valid[1] and not images.valid[6]
    assert fails == int((~images.valid).sum()) == dec.failures
    assert sum(dec.backend_counts.values()) == len(jpegs) - fails
    assert all(images.valid[i] for i in (0, 2, 3, 5))
    again = sum(bool(images.valid[i]) for i in shared)
    assert dec.backend_counts["gpu_hybrid_one_by_one"] == again > 0
    o, n = int(images.offsets[6]), 375 * 500 * 3
    assert images.flat[o:o + n].numel() == n
    assert not bool(images.flat[o:o + n].any())
    for i in (0, 2, 3, 5):
        assert _mad_vs_pil(images.image(i), jpegs[i]) < PIL_TOL_IMAGENET
    z = np.zeros(7, np.int64)
    out = ia.augment(images, z, z, z.astype(bool), (375, 500), (375, 500),
                     out="uint8", layout="NHWC")
    assert not bool(out[1].any()) and not bool(out[6].any())
