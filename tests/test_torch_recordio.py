"""The port's RecordIO (``mxnet_tpu_torch/recordio.py``) and host
data-path library (``mxnet_tpu_torch/native``) against the JAX
package's: record files written by one package read in the other and are
byte-identical for the same writes; headers, labels, ``pack_img`` bytes
and ``unpack_img`` images equal; the host library's index, batched
reads, JPEG decode (with the DCT-domain downscale), fused augment and
raw crops equal the JAX package's exactly (tolerance 0: both run the same
C++ over the same libjpeg).  The JAX tests' cases of
``tests/test_io_image.py`` that apply to these modules are repeated on
the port."""
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import native as jnative

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import native as tnative
import torch_records as tr
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    tr.jax_native()


PKGS = {"jax": mx, "port": mt}
MAGIC = b"\x0a\x23\xd7\xce"
PAYLOADS = [b"hello", b"x" * 1000, b"", MAGIC + b" embedded",
            b"two" + MAGIC + MAGIC + b"magics", b"end" + MAGIC]


def _write(pkg, path, indexed):
    rio = pkg.recordio
    if indexed:
        w = rio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
        for i, p in enumerate(PAYLOADS):
            w.write_idx(i, p)
    else:
        w = rio.MXRecordIO(path, "w")
        for p in PAYLOADS:
            w.write(p)
    w.close()


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_files_cross_between_packages(tmp_path, writer, reader, indexed):
    path = str(tmp_path / "t.rec")
    _write(PKGS[writer], path, indexed)
    rio = PKGS[reader].recordio
    if indexed:
        r = rio.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
        assert r.keys == list(range(len(PAYLOADS)))
        for k in (4, 0, 3):
            assert r.read_idx(k) == PAYLOADS[k]
    else:
        r = rio.MXRecordIO(path, "r")
        for p in PAYLOADS:
            assert r.read() == p
        assert r.read() is None
    r.close()


@pytest.mark.parametrize("indexed", [False, True])
def test_same_writes_give_identical_files(tmp_path, indexed):
    paths = {k: str(tmp_path / f"{k}.rec") for k in PKGS}
    for k, p in paths.items():
        _write(PKGS[k], p, indexed)
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["port"] == blobs["jax"]
    if indexed:
        idx = {k: open(p[:-4] + ".idx").read() for k, p in paths.items()}
        assert idx["port"] == idx["jax"]


@pytest.mark.parametrize("label", [3.5, 7, [1.0, 2.0, 3.0],
                                   np.arange(5, dtype=np.float32)])
def test_pack_and_unpack_headers_equal_jax(label):
    hdr = (0, label, 42, 9)
    s = mt.recordio.pack(hdr, b"payload")
    assert s == mx.recordio.pack(mx.recordio.IRHeader(*hdr), b"payload")
    th, tbody = mt.recordio.unpack(s)
    jh, jbody = mx.recordio.unpack(s)
    assert tbody == jbody == b"payload"
    np.testing.assert_array_equal(th.label, jh.label)
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)


@pytest.mark.parametrize("fmt,quality", [(".jpg", 95), (".jpg", 60),
                                         (".png", 95)])
def test_pack_img_bytes_equal_jax(fmt, quality):
    img = tr.images(1, (37, 51), seed=3)[0]
    hdr = (0, 1.0, 3, 0)
    t = mt.recordio.pack_img(hdr, img, quality=quality, img_fmt=fmt)
    j = mx.recordio.pack_img(mx.recordio.IRHeader(*hdr), img,
                             quality=quality, img_fmt=fmt)
    assert t == j


@pytest.mark.parametrize("iscolor", [1, 0])
def test_unpack_img_on_the_cpu_equals_jax(iscolor):
    img = tr.images(1, (30, 26), seed=4)[0]
    s = mx.recordio.pack_img(mx.recordio.IRHeader(0, 2.0, 1, 0), img)
    with mt.cpu():
        th, timg = mt.recordio.unpack_img(s, iscolor)
    jh, jimg = mx.recordio.unpack_img(s, iscolor)
    assert isinstance(timg, np.ndarray)
    np.testing.assert_array_equal(timg, jimg)
    assert th.label == jh.label


def test_readers_pickle_at_their_position(tmp_path):
    """An open reader pickles with its byte position.  The JAX package's
    indexed reader cannot come back (its ``__setstate__`` hands the byte
    position to the indexed ``seek``, which takes a key: a reference
    fault, ``mxnet_tpu/recordio.py:88``); the port's seeks the byte."""
    path = str(tmp_path / "p.rec")
    _write(mt, path, True)
    j = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
    j.read_idx(1)
    with pytest.raises(KeyError):
        pickle.loads(pickle.dumps(j))
    r = mt.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
    r.read_idx(1)
    back = pickle.loads(pickle.dumps(r))
    assert back.read() == PAYLOADS[2]
    assert back.read_idx(3) == PAYLOADS[3]
    seq = mt.recordio.MXRecordIO(path, "r")
    seq.read()
    again = pickle.loads(pickle.dumps(seq))
    assert again.read() == PAYLOADS[1]


def test_native_index_and_reads_equal_jax(tmp_path):
    """The continued records (embedded magics) take the assembling C
    read, the others are views of the mapped file."""
    path = str(tmp_path / "n.rec")
    _write(mx, path, True)
    offs = tnative.index_rec_file(path)
    np.testing.assert_array_equal(offs, jnative.index_rec_file(path))
    order = [5, 0, 3, 4, 4, 1]
    got = tnative.read_records(path, offs[order], offs)
    want = jnative.read_records(path, offs[order], offs)
    assert [bytes(g) for g in got] == [bytes(w) for w in want] == \
        [PAYLOADS[i] for i in order]


def _jpegs(n=9, seed=0, shape=(48, 40)):
    imgs = tr.images(n, shape, seed=seed)
    return [mx.recordio.unpack(mx.recordio.pack_img(
        mx.recordio.IRHeader(0, 0.0, i, 0), im, quality=90))[1]
        for i, im in enumerate(imgs)]


# (decode h, w): a resize up, one down, and one the DCT-domain downscale
# takes (images at least twice the size in both dimensions: 1/2 first)
@pytest.mark.parametrize("size", [(64, 60), (32, 32), (20, 18)])
@pytest.mark.parametrize("channels", [3, 1])
def test_native_decode_equals_jax(size, channels):
    jpegs = _jpegs() + [b"\xff\xd8 corrupt"]
    got, tf = tnative.decode_jpeg_batch(jpegs, *size, channels, 2)
    want, jf = jnative.decode_jpeg_batch(jpegs, *size, channels, 2)
    assert tf == jf == 1
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any()


def test_native_decode_is_near_pil():
    """The JAX test's bound: libjpeg's decode within a mean absolute 2
    levels of PIL's (IDCT and upsampling differ)."""
    jpg = _jpegs(1)[0]
    with mt.cpu():
        pil = mt.image.imdecode(jpg, to_ndarray=False)
    out, fails = tnative.decode_jpeg_batch([jpg], pil.shape[0],
                                           pil.shape[1], 3, 1)
    assert fails == 0
    assert np.abs(out[0].astype(int) - pil.astype(int)).mean() < 2.0


@pytest.mark.parametrize("channels", [3, 1])
def test_native_decode_augment_equals_jax(channels):
    jpegs = _jpegs(8, seed=2) + [b"junk"]
    n = len(jpegs)
    rng = np.random.RandomState(1)
    y0 = rng.randint(-3, 12, n)          # some past the edges: clamped
    x0 = rng.randint(-3, 12, n)
    flips = rng.rand(n) < 0.5
    mean = np.array([123.68, 116.779, 103.939], np.float32)[:channels]
    std = np.array([58.4, 57.1, 57.4], np.float32)[:channels]
    args = (jpegs, 40, 36, 32, 30, y0, x0, flips, mean, std, channels, 2)
    got, tf = tnative.decode_augment_batch(*args)
    want, jf = jnative.decode_augment_batch(*args)
    assert tf == jf == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nhwc", [False, True])
def test_native_raw_crops_equal_jax(tmp_path, nhwc):
    imgs = np.random.RandomState(3).randint(0, 256, (5, 30, 34, 3),
                                            dtype=np.uint8)
    raws = [im.tobytes() for im in imgs]
    y0 = np.array([0, 4, 9, -2, 2])
    x0 = np.array([1, 0, 12, 3, -1])
    flips = np.array([0, 1, 1, 0, 1], bool)
    name = "crop_flip_u8_nhwc_batch" if nhwc else "crop_flip_u8_batch"
    got = getattr(tnative, name)(raws, 30, 34, 24, 28, y0, x0, flips, 3, 2)
    want = getattr(jnative, name)(raws, 30, 34, 24, 28, y0, x0, flips, 3, 2)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="payload"):
        getattr(tnative, name)(raws[:1] + [b"x"], 30, 34, 24, 28, y0[:2],
                               x0[:2], flips[:2], 3, 2)


def test_host_libraries_build_at_first_use_and_report():
    assert tnative.available("rec_io") and tnative.available("jpeg_io")
    for stem in tnative.SOURCES:
        path = tnative._lib_path(stem)
        assert path.startswith(tnative.BUILD_DIR)
        assert path.endswith(f"lib{stem}.so")


def test_missing_library_raises_and_is_not_replaced(monkeypatch, tmp_path):
    """A library that does not build raises the compiler's complaint;
    nothing falls back to another decoder."""
    monkeypatch.setitem(tnative.SOURCES, "jpeg_io",
                        (["-O3", "-fPIC", "-shared", "-DNO_SUCH=1",
                          "-include", "no_such_header.h"], []))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "_errors", {})
    with pytest.raises(mt.MXNetError, match="build failed"):
        tnative.decode_jpeg_batch(_jpegs(1), 8, 8)
    assert not tnative.available("jpeg_io")
