"""The port's ``mx.image`` (``mxnet_tpu_torch/image/image.py``) and the
Gluon record datasets against the JAX package's, on the CPU: ``imdecode``
and the resize and crop functions, every augmenter and ``CreateAugmenter``
under the same Python ``random`` and numpy seeds, ``ImageIter`` over a
record file, ``RecordFileDataset`` and ``ImageRecordDataset`` (through a
``DataLoader`` too).  Both packages run PIL and numpy on the host, so the
results are equal exactly (tolerance 0).  Also the JAX tests' cases of
``tests/test_io_image.py`` for these functions."""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_records as tr
import torch_threads  # noqa: F401,E402  a worker's share of the cores

PKGS = (mx, mt)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("img") / "data.rec")
    tr.write_jpeg(path, tr.images(12, (48, 40), seed=0))
    return path


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _run(pkg, fn, seed=0):
    """``fn(pkg)`` with Python's and numpy's global generators at
    ``seed``, on the port's CPU."""
    random.seed(seed)
    np.random.seed(seed)
    if pkg is mt:
        with mt.cpu():
            return fn(pkg)
    return fn(pkg)


def _same(fn, seed=0):
    j, t = _run(mx, fn, seed), _run(mt, fn, seed)
    if isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(_np(b), _np(a))
    else:
        np.testing.assert_array_equal(_np(t), _np(j))
    return t


def _img(shape=(40, 60), seed=0):
    return tr.images(1, shape, seed=seed, vary=False)[0]


@pytest.mark.parametrize("flag,to_rgb", [(1, 1), (1, 0), (0, 1)])
def test_imdecode_equals_jax(flag, to_rgb):
    jpg = mx.recordio.unpack(mx.recordio.pack_img(
        mx.recordio.IRHeader(0, 0.0, 0, 0), _img()))[1]
    t = _same(lambda p: p.image.imdecode(jpg, flag, to_rgb))
    assert t.context.device_type == "cpu" and t.dtype == np.uint8


FUNCS = {
    "imresize": lambda p, a: p.image.imresize(a, 33, 21),
    "imresize_nearest": lambda p, a: p.image.imresize(a, 70, 50, interp=0),
    "resize_short": lambda p, a: p.image.resize_short(a, 32),
    "fixed_crop": lambda p, a: p.image.fixed_crop(a, 3, 5, 20, 17, (16, 16)),
    "random_crop": lambda p, a: p.image.random_crop(a, (16, 16))[0],
    "center_crop": lambda p, a: p.image.center_crop(a, (20, 24))[0],
    "random_size_crop": lambda p, a: p.image.random_size_crop(
        a, (20, 20), 0.3, (0.75, 1.33))[0],
    "color_normalize": lambda p, a: p.image.color_normalize(
        a.astype(np.float32), np.array([128, 120, 110], np.float32),
        np.array([2, 3, 4], np.float32)),
    "scale_down": lambda p, a: np.array(p.image.scale_down((40, 30),
                                                           (60, 50))),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functions_equal_jax(name):
    a = _img()
    _same(lambda p: FUNCS[name](p, a), seed=3)


AUGS = {
    "ResizeAug": lambda p: p.image.ResizeAug(30),
    "ForceResizeAug": lambda p: p.image.ForceResizeAug((30, 26)),
    "RandomCropAug": lambda p: p.image.RandomCropAug((24, 20)),
    "RandomSizedCropAug": lambda p: p.image.RandomSizedCropAug(
        (24, 24), 0.08, (3 / 4, 4 / 3)),
    "CenterCropAug": lambda p: p.image.CenterCropAug((24, 20)),
    "HorizontalFlipAug": lambda p: p.image.HorizontalFlipAug(0.5),
    "CastAug": lambda p: p.image.CastAug(),
    "BrightnessJitterAug": lambda p: p.image.BrightnessJitterAug(0.3),
    "ContrastJitterAug": lambda p: p.image.ContrastJitterAug(0.3),
    "SaturationJitterAug": lambda p: p.image.SaturationJitterAug(0.3),
    "ColorJitterAug": lambda p: p.image.ColorJitterAug(0.2, 0.3, 0.4),
    "LightingAug": lambda p: p.image.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]])),
    "ColorNormalizeAug": lambda p: p.image.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
    "RandomOrderAug": lambda p: p.image.RandomOrderAug(
        [p.image.BrightnessJitterAug(0.2), p.image.CastAug(),
         p.image.HorizontalFlipAug(0.5)]),
    "SequentialAug": lambda p: p.image.SequentialAug(
        [p.image.ResizeAug(30), p.image.CenterCropAug((20, 20))]),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenters_equal_jax(name):
    a = _img((44, 52), seed=1)

    def run(p):
        aug = AUGS[name](p)
        out = [o for _ in range(4) for o in aug(a)]
        try:
            dumped = aug.dumps()
        except TypeError as e:
            # ColorNormalizeAug keeps numpy arrays in its kwargs: json
            # refuses them in both packages
            dumped = type(e).__name__
        return out + [np.frombuffer(dumped.encode(), np.uint8)]
    _same(run, seed=5)


@pytest.mark.parametrize("kw", [
    dict(resize=40, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, brightness=0.1, contrast=0.1,
         saturation=0.1, pca_noise=0.05, mean=True, std=True),
    dict(mean=np.array([1.0, 2.0, 3.0]), inter_method=1),
])
def test_create_augmenter_equals_jax(kw):
    a = _img((50, 46), seed=2)

    def run(p):
        augs = p.image.CreateAugmenter((3, 28, 28), **kw)
        data = [a]
        for aug in augs:
            data = [r for s in data for r in aug(s)]
        assert [type(x).__name__ for x in augs]
        return data
    _same(run, seed=9)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True, resize=40),
    dict(rand_crop=True, brightness=0.1, contrast=0.1, saturation=0.1,
         pca_noise=0.05, mean=True, std=True, part_index=1, num_parts=2),
])
def test_image_iter_equals_jax(rec, kw):
    def run(p):
        it = p.image.ImageIter(batch_size=5, data_shape=(3, 28, 28),
                               path_imgrec=rec, **kw)
        out = []
        for _ in range(2):
            for b in it:
                out += [b.data[0].asnumpy(), b.label[0].asnumpy(),
                        np.array([b.pad])]
            it.reset()
        return out
    _same(run, seed=4)


def test_image_iter_over_a_list_and_files(tmp_path):
    imgs = tr.images(5, (30, 34), seed=6)
    from PIL import Image
    lines = []
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(tmp_path / f"{i}.jpg", quality=90)
        lines.append(f"{i}\t{i % 3}\t{i}.jpg")
    (tmp_path / "list.lst").write_text("\n".join(lines) + "\n")

    def run(p):
        out = []
        for src in (dict(path_imglist=str(tmp_path / "list.lst"),
                         path_root=str(tmp_path)),
                    dict(imglist=[[float(i % 3), f"{i}.jpg"]
                                  for i in range(5)],
                         path_root=str(tmp_path))):
            it = p.image.ImageIter(batch_size=2, data_shape=(3, 24, 24),
                                   shuffle=True, rand_crop=True, **src)
            out += [x for b in it for x in (b.data[0], b.label[0])]
        return out
    _same(run, seed=2)


def test_record_datasets_equal_jax(rec):
    from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JDS
    jraw = mx.gluon.data.RecordFileDataset(rec)
    traw = mt.gluon.data.RecordFileDataset(rec)
    assert len(traw) == len(jraw) == 12
    assert [traw[i] for i in range(12)] == [jraw[i] for i in range(12)]
    for flag in (1, 0):
        jds = JDS(rec, flag)
        tds = mt.gluon.data.vision.ImageRecordDataset(rec, flag)
        for i in (0, 5, 11):
            (ti, tl), (ji, jl) = tds[i], jds[i]
            assert ti.context.device_type == "cpu"
            np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
            assert tl == jl == float(i % 7)
    t = mt.gluon.data.vision.ImageRecordDataset(
        rec, transform=lambda x, y: (x.asnumpy().mean(), y * 2))
    j = JDS(rec, transform=lambda x, y: (x.asnumpy().mean(), y * 2))
    assert t[3] == j[3]


def test_image_record_dataset_through_a_dataloader(rec):
    """The JAX test's case, through the port's DataLoader with worker
    threads: shapes and labels of every batch."""
    ds = mt.gluon.data.vision.ImageRecordDataset(
        rec, transform=lambda x, y: (
            mt.nd.array(x.asnumpy()[:40, :40].transpose(2, 0, 1),
                        ctx=mt.cpu(), dtype="float32"), y))
    with mt.cpu():
        loader = mt.gluon.data.DataLoader(ds, batch_size=4, num_workers=2)
        got = [(x.shape, y.asnumpy()) for x, y in loader]
    assert [g[0] for g in got] == [(4, 3, 40, 40)] * 3
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                  [i % 7 for i in range(12)])


def test_contrast_jitter_preserves_gray_mean():
    gray = np.full((10, 10, 3), 100, np.uint8)
    with mt.cpu():
        out = mt.image.ContrastJitterAug(0.5)(gray)[0].asnumpy()
    lum = (out * np.array([[[0.299, 0.587, 0.114]]])).sum(2)
    np.testing.assert_allclose(lum.mean(), 100.0 * (0.299 + 0.587 + 0.114),
                               rtol=0.05)


def test_unpack_img_decodes_on_the_card_only_in_a_gpu_context(monkeypatch):
    """``recordio.unpack_img`` decodes through nvJPEG in a GPU context and
    through PIL in a CPU one: a CPU context never reaches nvJPEG, and a
    GPU context without CUDA raises instead of decoding on the host."""
    from mxnet_tpu_torch.image import nvjpeg
    rec = mx.recordio.pack_img(mx.recordio.IRHeader(0, 0.0, 0, 0), _img())

    def no_card(*args):
        raise AssertionError("nvJPEG reached in a CPU context")
    monkeypatch.setattr(nvjpeg, "decode_one", no_card)
    with mt.cpu():
        _, img = mt.recordio.unpack_img(rec)
    np.testing.assert_array_equal(img, mx.recordio.unpack_img(rec)[1])
    if not torch.cuda.is_available():
        with mt.gpu(0), pytest.raises(mt.MXNetError, match="CUDA"):
            mt.recordio.unpack_img(rec)
