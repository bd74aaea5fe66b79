"""I1, the record iterators' resize -> crop -> mirror -> normalize kernel
(``csrc/image_augment.cu`` ``image_augment_kernel``), run on the CPU under
the emulation of the CUDA runtime in ``tests/cuda_emu/``, against its
plain version (``ops/image_augment.py`` ``augment_plain``) bit for bit.

The emulation computes in IEEE single precision without contraction, as
the card does with the kernel's ``__f*_rn`` operations and as PyTorch's
CPU kernels do, so the kernel's batch must equal the plain version's
exactly: images of differing sizes within a batch (resized up, down and
not at all), crop offsets past both edges (clamped), mirror, grey and
RGB, the three outputs (float32 NCHW, uint8 NCHW and NHWC), and a
zero-filled failed slot.  The output starts as 0xAB bytes, so a byte no
thread writes shows.  The plain version also equals the JAX package's
host code (``jpeg_decode_augment_batch``) on the same decoded pixels.
What it cannot: what nvcc makes of the source, or speed
(``chip_smoke.py``).  Skips without a host C++ compiler."""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emu.build import build
from mxnet_tpu_torch.ops import image_augment as ia
import torch_records as tr
import torch_threads  # noqa: F401,E402  a worker's share of the cores

KINDS = {("float32", "NCHW"): 0, ("uint8", "NCHW"): 1, ("uint8", "NHWC"): 2}

# sizes of the images (h, w), decode size, crop, channels, output, a failed
# slot
CASES = {
    "rgb_float_mixed_sizes": ([(40, 36), (30, 30), (52, 61), (17, 23)],
                              (30, 30), (24, 26), 3, ("float32", "NCHW"),
                              None),
    "grey_float_with_failed_slot": ([(20, 22), (30, 30), (41, 37)], (30, 30),
                                    (28, 30), 1, ("float32", "NCHW"), 1),
    "rgb_uint8_nchw_raw": ([(20, 24)] * 3, (20, 24), (16, 20), 3,
                           ("uint8", "NCHW"), None),
    "rgb_uint8_nhwc_resized": ([(25, 19), (13, 40), (20, 24)], (20, 24),
                               (12, 20), 3, ("uint8", "NHWC"), 2),
    "crop_equals_decode": ([(33, 31), (16, 16)], (16, 16), (16, 16), 3,
                           ("float32", "NCHW"), None),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("image_augment.cu", str(tmp_path_factory.mktemp("emu_aug")),
                launches=3, extern_shared=0)
    lib.mxtt_image_augment.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def _inputs(sizes, c, failed, seed):
    imgs = [tr.images(1, s, seed=seed + i, channels=c, vary=False)[0]
            for i, s in enumerate(sizes)]
    if failed is not None:
        imgs[failed] = None
    images = ia.DecodedImages.from_arrays(imgs, channels=c)
    n = len(sizes)
    rng = np.random.RandomState(seed)
    y0 = rng.randint(-4, 12, n)
    x0 = rng.randint(-4, 12, n)
    flips = np.arange(n) % 2 == 1
    return images, y0, x0, flips


def _kernel(lib, images, y0, x0, flips, dec, crop, out, layout, mean, std):
    c = images.channels
    n = len(images)
    shape = (n, crop[0], crop[1], c) if layout == "NHWC" \
        else (n, c, crop[0], crop[1])
    buf = torch.full((int(np.prod(shape)) * (4 if out == "float32" else 1),),
                     0xAB, dtype=torch.uint8)
    meta = torch.from_numpy(ia._meta(images, y0, x0, flips)).contiguous()
    m, inv = ia._norm(mean, std, c)
    norm = torch.cat([m, inv])
    err = lib.mxtt_image_augment(meta.data_ptr(), norm.data_ptr(),
                                 buf.data_ptr(), n, c, dec[0], dec[1],
                                 crop[0], crop[1], KINDS[(out, layout)], 0,
                                 None)
    assert err == 0
    return buf.view(getattr(torch, out)).view(shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_augment_kernel_equals_plain_version_bit_for_bit(lib, case):
    sizes, dec, crop, c, (out, layout), failed = CASES[case]
    images, y0, x0, flips = _inputs(sizes, c, failed,
                                    sorted(CASES).index(case))
    mean = np.array([123.68, 116.779, 103.939], np.float32)[:c]
    std = np.array([58.4, 57.1, 57.4], np.float32)[:c]
    want = ia.augment_plain(images, y0, x0, flips, dec, crop, mean, std, out,
                            layout)
    got = _kernel(lib, images, y0, x0, flips, dec, crop, out, layout, mean,
                  std)
    again = _kernel(lib, images, y0, x0, flips, dec, crop, out, layout, mean,
                    std)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = int((got != want).sum())
    assert diff == 0, f"{diff} of {want.numel()} values differ"
    assert torch.equal(got, again)
    if failed is not None:
        slot = got[failed].to(torch.float32)
        zero = ((0 - torch.from_numpy(mean)) *
                (np.float32(1) / torch.from_numpy(std))) \
            if out == "float32" else torch.zeros(c)
        axis = -1 if layout == "NHWC" else 0
        per_channel = slot.movedim(axis, -1).reshape(-1, c)
        assert torch.equal(per_channel, zero.expand_as(per_channel))


def test_plain_version_equals_the_host_code_on_the_same_pixels():
    """The plain version against the host C++ the port copies
    (``native/jpeg_io.cc``): decode JPEGs with the host library at their
    own size (no resize), then resize, crop, mirror and normalize with
    the plain version; the host's fused pass must give the same batch."""
    from mxnet_tpu_torch import native
    import mxnet_tpu as mx
    imgs = tr.images(6, (44, 38), seed=3)
    jpegs = [mx.recordio.unpack(mx.recordio.pack_img(
        mx.recordio.IRHeader(0, 0.0, 0, 0), im, quality=90))[1]
        for im in imgs]
    decoded = [native.decode_jpeg_batch([j], im.shape[0], im.shape[1], 3,
                                        1)[0][0]
               for j, im in zip(jpegs, imgs)]
    images = ia.DecodedImages.from_arrays(decoded)
    rng = np.random.RandomState(0)
    y0, x0 = rng.randint(0, 8, 6), rng.randint(0, 8, 6)
    flips = rng.rand(6) < 0.5
    mean = np.array([123.68, 116.779, 103.939], np.float32)
    std = np.array([58.4, 57.1, 57.4], np.float32)
    # decode size (40, 36): every image is below twice it, so the host
    # decodes at full size too (no DCT-domain downscale)
    want, fails = native.decode_augment_batch(jpegs, 40, 36, 32, 30, y0, x0,
                                              flips, mean, std, 3, 1)
    assert fails == 0
    got = ia.augment_plain(images, y0, x0, flips, (40, 36), (32, 30), mean,
                           std)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bound_counts_the_taps_the_crop_reaches():
    imgs = [np.zeros((40, 40, 3), np.uint8), np.zeros((20, 20, 3), np.uint8)]
    images = ia.DecodedImages.from_arrays(imgs + [None])
    # image 0: 40 -> 20 then a 10 x 10 crop at 0 reaches 20 source rows and
    # columns; image 1 is not resized: the crop's 100 pixels; the failed
    # slot reads nothing; the output 3 x 100 float32 values
    got = ia.bound_bytes(images, [0, 0, 0], [0, 0, 0], [0, 0, 0], (20, 20),
                         (10, 10), 4)
    assert got == (20 * 20 * 3) + (10 * 10 * 3) + 3 * 300 * 4
