"""The port's detection data path (``mxnet_tpu_torch/image/detection.py``)
against the JAX package's, on the CPU: ``make_det_label`` and
``parse_det_label``, ``pack_det_dataset`` files, ``ImageDetRecordIter``
with ``device=cpu()`` (labels after the crop sampler and mirror, and the
pixels), ``ImageDetIter``, every ``Det*Aug`` and ``CreateDetAugmenter``
under the same seeds.  Tolerance 0: the same libjpeg C++ decodes in both
packages, and the crop sampler draws the same numbers from the same
``RandomState`` in the same order.  Also the JAX tests' cases of
``tests/test_ssd.py:51-90``: the batches' shapes and boxes, and the toy
SSD trained through ``Module`` from the iterator."""
import random

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.image import detection as jdet

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.image import detection as tdet
import torch_records as tr
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    tr.jax_native()


def _toy_dataset(n=12, size=64, seed=7, objects=3):
    """Bright squares on dark noise, up to ``objects`` an image, classes
    0-2 (the JAX test's toy set, with more objects)."""
    rng = np.random.RandomState(seed)
    images, classes, boxes = [], [], []
    for _ in range(n):
        im = rng.randint(0, 60, (size, size + 8, 3)).astype(np.uint8)
        k = rng.randint(1, objects + 1)
        cl, bx = [], []
        for _ in range(k):
            s = rng.randint(size // 6, size // 2)
            y0, x0 = rng.randint(0, size - s), rng.randint(0, size + 8 - s)
            im[y0:y0 + s, x0:x0 + s] = 200 + 20 * len(cl)
            cl.append(float(len(cl)))
            bx.append([x0 / (size + 8), y0 / size, (x0 + s) / (size + 8),
                       (y0 + s) / size])
        images.append(im)
        classes.append(cl)
        boxes.append(bx)
    return images, classes, boxes


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("det") / "det.rec")
    jdet.pack_det_dataset(path, *_toy_dataset())
    return path


def test_pack_det_dataset_files_are_identical(tmp_path):
    data = _toy_dataset(5, seed=3)
    jdet.pack_det_dataset(str(tmp_path / "j.rec"), *data)
    tdet.pack_det_dataset(str(tmp_path / "t.rec"), *data, quality=95)
    assert (tmp_path / "t.rec").read_bytes() == \
        (tmp_path / "j.rec").read_bytes()


@pytest.mark.parametrize("max_objects", [1, 4])
def test_det_labels_equal_jax(max_objects):
    flat = tdet.make_det_label([1.0, 3.0], [[0.1, 0.2, 0.3, 0.4],
                                            [0.5, 0.5, 0.9, 0.9]])
    np.testing.assert_array_equal(flat, jdet.make_det_label(
        [1.0, 3.0], [[0.1, 0.2, 0.3, 0.4], [0.5, 0.5, 0.9, 0.9]]))
    lab = tdet.parse_det_label(flat, max_objects)
    np.testing.assert_array_equal(lab, jdet.parse_det_label(flat,
                                                            max_objects))
    np.testing.assert_allclose(lab[0], [1.0, 0.1, 0.2, 0.3, 0.4])
    np.testing.assert_array_equal(tdet.parse_det_label([1.0], 2), -1)


CASES = {
    "plain": dict(),
    "mirror_shuffle": dict(rand_mirror=True, shuffle=True, seed=3),
    # the crop sampler on half the images, with mean and std (divided, as
    # the JAX package's det path divides)
    "crop_mirror_norm": dict(rand_crop=0.5, rand_mirror=True, shuffle=True,
                             min_crop_scale=0.3, mean_r=120.0, mean_g=110.0,
                             mean_b=100.0, std_r=60.0, std_g=58.0,
                             std_b=57.0, seed=11),
    "crop_always": dict(rand_crop=1.0, seed=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_det_record_iter_equals_jax(det_rec, case):
    kw = dict(data_shape=(3, 48, 56), batch_size=5, max_objects=4,
              preprocess_threads=2, **CASES[case])
    j = mx.io.ImageDetRecordIter(det_rec, **kw)
    t = mt.io.ImageDetRecordIter(det_rec, device=mt.cpu(), **kw)
    jb, tb = tr.batches(j, 2), tr.batches(t, 2)
    assert len(tb) == len(jb) == 6
    assert t.provide_label[0].shape == j.provide_label[0].shape == (5, 4, 5)
    for (jd, jl, jp), (td, tl, tp) in zip(jb, tb):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(td, jd)
        assert tp == jp
    labs = np.concatenate([b[1] for b in tb])
    valid = labs[..., 0] >= 0
    b = labs[valid]
    assert valid.any() and (b[:, 1] <= b[:, 3]).all() \
        and (b[:, 2] <= b[:, 4]).all()
    assert b[:, 1:].min() >= 0.0 and b[:, 1:].max() <= 1.0


def _seeded(pkg, fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    if pkg is mt:
        with mt.cpu():
            return fn(pkg)
    return fn(pkg)


def test_det_iter_equals_jax(det_rec):
    def run(pkg):
        it = pkg.image.ImageDetIter(batch_size=4, data_shape=(3, 40, 40),
                                    path_imgrec=det_rec, max_objects=4,
                                    rand_mirror=True, shuffle=True, seed=5)
        return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it]
    j, t = _seeded(mx, run, 1), _seeded(mt, run, 1)
    assert len(t) == len(j) == 3
    for (jd, jl, jp), (td, tl, tp) in zip(j, t):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp


@pytest.mark.parametrize("kw", [
    dict(rand_crop=0.7, rand_pad=0.5, rand_mirror=True, seed=4),
    dict(resize=50, rand_crop=1.0, min_crop_scale=0.4, mean=True, std=True,
         brightness=0.2, seed=1),
    dict(rand_pad=1.0, max_pad_scale=3.0, pad_val=(10, 20, 30)),
])
def test_det_augmenters_equal_jax(det_rec, kw):
    images, classes, boxes = _toy_dataset(4, seed=9)

    def run(pkg):
        augs = pkg.image.CreateDetAugmenter((3, 40, 44), **kw)
        out = []
        for im, cl, bx in zip(images, classes, boxes):
            lab = pkg.image.parse_det_label(
                pkg.image.make_det_label(cl, bx), 4)
            d = im
            for aug in augs:
                d, lab = aug(d, lab)
            out += [d.asnumpy(), lab]
        return out + [[a.dumps() for a in augs]]
    j, t = _seeded(mx, run, 6), _seeded(mt, run, 6)
    assert t[-1] == j[-1]
    for a, b in zip(j[:-1], t[:-1]):
        np.testing.assert_array_equal(b, a)


def test_det_iter_with_det_augmenters_equals_jax(det_rec):
    def run(pkg):
        augs = pkg.image.CreateDetAugmenter((3, 40, 40), rand_crop=0.5,
                                            rand_mirror=True, seed=3)
        it = pkg.image.ImageDetIter(batch_size=6, data_shape=(3, 40, 40),
                                    path_imgrec=det_rec, max_objects=4,
                                    det_aug_list=augs)
        return [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    j, t = _seeded(mx, run, 2), _seeded(mt, run, 2)
    for (jd, jl), (td, tl) in zip(j, t):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)


def test_toy_ssd_trains_from_the_det_iterator(tmp_path):
    """tests/test_ssd.py's toy SSD (one class), trained a few epochs
    through Module from ImageDetRecordIter on the CPU: the location loss
    falls."""
    images, classes, boxes = [], [], []
    rng = np.random.RandomState(7)
    for _ in range(16):
        im = rng.randint(0, 60, (64, 64, 3)).astype(np.uint8)
        s = rng.randint(16, 32)
        y0, x0 = rng.randint(0, 64 - s), rng.randint(0, 64 - s)
        im[y0:y0 + s, x0:x0 + s] = 255
        images.append(im)
        classes.append([0.0])
        boxes.append([[x0 / 64, y0 / 64, (x0 + s) / 64, (y0 + s) / 64]])
    rec = str(tmp_path / "train_det.rec")
    tdet.pack_det_dataset(rec, images, classes, boxes)
    it = mt.io.ImageDetRecordIter(rec, data_shape=(3, 64, 64), batch_size=8,
                                  max_objects=4, shuffle=True, seed=1,
                                  device=mt.cpu())
    net = mt.models.ssd_toy(num_classes=1, mode="train")
    mod = mt.mod.Module(net, context=mt.cpu(), data_names=("data",),
                        label_names=("label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mt.random.seed(3)
    np.random.seed(3)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9})
    losses = []
    for _ in range(5):
        it.reset()
        tot = 0.0
        for batch in it:
            mod.forward(batch, is_train=True)
            tot += float(mod.get_outputs()[1].asnumpy().sum())
            mod.backward()
            mod.update()
        losses.append(tot)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
