"""I1, the record iterators' resize -> crop -> mirror -> normalize kernel
(``csrc/image_augment.cu`` ``image_augment_kernel``), run on the CPU under
the emulation of the CUDA runtime in ``tests/cuda_emu/``, against its
plain version (``ops/image_augment.py`` ``augment_plain``) bit for bit.

The emulation computes in IEEE single precision without contraction, as
the card does with the kernel's ``__f*_rn`` operations and as PyTorch's
CPU kernels do, so the kernel's batch must equal the plain version's
exactly: images of differing sizes within a batch (resized up, down and
not at all), crop offsets past both edges (clamped), mirror, grey and
RGB, 2 and 4 channels, the three outputs (float32 NCHW, uint8 NCHW and
NHWC), a zero-filled failed slot, images that start off 16-byte
alignment in the flat buffer, widths that are not a multiple of 4 and a
last band that ends past the crop, mirrored crops clamped at both edges,
a downscale whose window the kernel does not stage, and an output off its
16-byte alignment.  The output starts as 0xAB bytes, so a byte no thread
writes shows.  The plain version also equals the JAX package's
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
# slot, and options: "seed" (each case's own, fixed), "pad" (bytes before
# the first image in the flat buffer, so no image starts 16-byte
# aligned), "offsets" (y0s, x0s in place of random draws), "flips" (in
# place of odd slots), "misaligned" (the output 4 bytes off its 16-byte
# alignment: scalar stores at a width that is a multiple of 4)
CASES = {
    "rgb_float_mixed_sizes": ([(40, 36), (30, 30), (52, 61), (17, 23)],
                              (30, 30), (24, 26), 3, ("float32", "NCHW"),
                              None, {"seed": 2}),
    "grey_float_with_failed_slot": ([(20, 22), (30, 30), (41, 37)], (30, 30),
                                    (28, 30), 1, ("float32", "NCHW"), 1,
                                    {"seed": 1}),
    "rgb_uint8_nchw_raw": ([(20, 24)] * 3, (20, 24), (16, 20), 3,
                           ("uint8", "NCHW"), None, {"seed": 3}),
    "rgb_uint8_nhwc_resized": ([(25, 19), (13, 40), (20, 24)], (20, 24),
                               (12, 20), 3, ("uint8", "NHWC"), 2,
                               {"seed": 4}),
    "crop_equals_decode": ([(33, 31), (16, 16)], (16, 16), (16, 16), 3,
                           ("float32", "NCHW"), None, {"seed": 0}),
    # every image starts off 16-byte alignment (a 5-byte prefix, odd sizes)
    "unaligned_image_offsets": ([(37, 29), (31, 33), (30, 30), (29, 41)],
                                (30, 30), (24, 24), 3, ("float32", "NCHW"),
                                None, {"seed": 5, "pad": 5}),
    # ow 23 (not a multiple of 4) and oh 13 (a band of 5 rows past the
    # first 8), in all three outputs
    "ragged_float": ([(35, 27), (30, 30), (21, 44)], (30, 30), (13, 23), 3,
                     ("float32", "NCHW"), None, {"seed": 6, "pad": 3}),
    "ragged_uint8_nchw": ([(30, 30), (35, 27)], (30, 30), (13, 23), 3,
                          ("uint8", "NCHW"), None, {"seed": 7}),
    "ragged_uint8_nhwc": ([(30, 30), (35, 27)], (30, 30), (13, 23), 3,
                          ("uint8", "NHWC"), None, {"seed": 8, "pad": 7}),
    # mirrored crops clamped at both edges (past the high edge, below 0),
    # resized and not
    "mirrored_clamped_edges": ([(40, 50), (30, 32), (30, 32), (26, 20)],
                               (30, 32), (20, 20), 3, ("float32", "NCHW"),
                               None, {"seed": 9, "offsets": (
                                   [100, -7, 100, -3], [-5, 100, 100, -9]),
                                   "flips": [True] * 4}),
    "two_channels": ([(22, 25), (20, 24), (31, 19)], (20, 24), (16, 20), 2,
                     ("float32", "NCHW"), None, {"seed": 10}),
    "four_channels": ([(22, 25), (20, 24), (31, 19)], (20, 24), (16, 20), 4,
                      ("uint8", "NHWC"), 1, {"seed": 11}),
    "four_channels_nchw": ([(20, 24), (27, 19)], (20, 24), (16, 20), 4,
                           ("uint8", "NCHW"), None, {"seed": 12}),
    # a downscale of 10: the band's window exceeds the staging buffer, so
    # the taps come from device memory
    "large_downscale_unstaged": ([(200, 180), (20, 18), (160, 230)],
                                 (20, 18), (16, 16), 3,
                                 ("float32", "NCHW"), None, {"seed": 13}),
    "misaligned_output": ([(25, 22), (20, 20)], (20, 20), (16, 16), 3,
                          ("float32", "NCHW"), None,
                          {"seed": 14, "misaligned": True}),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build("image_augment.cu", str(tmp_path_factory.mktemp("emu_aug")),
                launches=1, extern_shared=1)
    lib.mxtt_image_augment.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def _inputs(sizes, c, failed, opts):
    seed = opts["seed"]
    imgs = [tr.images(1, s, seed=seed + i, channels=c, vary=False)[0]
            for i, s in enumerate(sizes)]
    if failed is not None:
        imgs[failed] = None
    images = ia.DecodedImages.from_arrays(imgs, channels=c)
    pad = opts.get("pad", 0)
    if pad:
        images = ia.DecodedImages(
            torch.cat([torch.full((pad,), 7, dtype=torch.uint8),
                       images.flat]), images.offsets + pad, images.heights,
            images.widths, c, images.valid)
    n = len(sizes)
    rng = np.random.RandomState(seed)
    y0 = rng.randint(-4, 12, n)
    x0 = rng.randint(-4, 12, n)
    if "offsets" in opts:
        y0, x0 = (np.array(a) for a in opts["offsets"])
    flips = np.array(opts.get("flips", np.arange(n) % 2 == 1))
    return images, y0, x0, flips


def _kernel(lib, images, y0, x0, flips, dec, crop, out, layout, mean, std,
            misaligned=False):
    c = images.channels
    n = len(images)
    shape = (n, crop[0], crop[1], c) if layout == "NHWC" \
        else (n, c, crop[0], crop[1])
    nbytes = int(np.prod(shape)) * (4 if out == "float32" else 1)
    skip = 4 if misaligned else 0
    buf = torch.full((nbytes + skip,), 0xAB, dtype=torch.uint8)
    meta = torch.from_numpy(ia._meta(images, y0, x0, flips, mean, std))
    err = lib.mxtt_image_augment(meta.data_ptr(), buf.data_ptr() + skip, n,
                                 c, dec[0], dec[1], crop[0], crop[1],
                                 KINDS[(out, layout)], 0, None)
    assert err == 0
    return buf[skip:].clone().view(getattr(torch, out)).view(shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_augment_kernel_equals_plain_version_bit_for_bit(lib, case):
    sizes, dec, crop, c, (out, layout), failed, opts = CASES[case]
    images, y0, x0, flips = _inputs(sizes, c, failed, opts)
    mean = np.array([123.68, 116.779, 103.939, 99.5], np.float32)[:c]
    std = np.array([58.4, 57.1, 57.4, 51.3], np.float32)[:c]
    want = ia.augment_plain(images, y0, x0, flips, dec, crop, mean, std, out,
                            layout)
    got = _kernel(lib, images, y0, x0, flips, dec, crop, out, layout, mean,
                  std, opts.get("misaligned", False))
    again = _kernel(lib, images, y0, x0, flips, dec, crop, out, layout, mean,
                    std, opts.get("misaligned", False))
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


def test_cases_reach_every_path_of_the_kernel():
    """The new cases do what their names say: no image of the unaligned
    case starts on a 16-byte boundary; the clamped case's offsets fall
    past both edges; the large downscale's band window (8 output rows,
    about 80 source rows of 480 bytes) is more than the kernel stages."""
    images, *_ = _inputs(*[CASES["unaligned_image_offsets"][k]
                           for k in (0, 3, 5, 6)])
    assert ((images.offsets + images.flat.data_ptr()) % 16 != 0).all()
    _, y0, x0, flips = _inputs(*[CASES["mirrored_clamped_edges"][k]
                                 for k in (0, 3, 5, 6)])
    (dh, dw), (oh, ow) = CASES["mirrored_clamped_edges"][1:3]
    assert (y0 > dh - oh).any() and (y0 < 0).any()
    assert (x0 > dw - ow).any() and (x0 < 0).any() and flips.all()
    (h, w), (dh, dw) = CASES["large_downscale_unstaged"][0][0], \
        CASES["large_downscale_unstaged"][1]
    ow = CASES["large_downscale_unstaged"][2][1]
    rows, span = 8 * h // dh, ow * w // dw * 3
    assert rows * span > 24576  # STAGE_BYTES of csrc/image_augment.cu


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
