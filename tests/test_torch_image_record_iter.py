"""The port's ``ImageRecordIter`` and ``ImageRecordUInt8Iter`` with
``device=cpu()`` against the JAX package's: for the same record file,
seed and arguments, every batch, label and pad of two epochs equal
exactly.  Tolerance 0: both decode through the same C++ over the same
libjpeg (the JAX package's ``io_native.cc``, the port's copy of it in
``native/jpeg_io.cc``; the JAX package takes that fused path wherever its
library builds, as it does here) and draw the same crops and flips from
the same ``RandomState``.  Also: a producer error surfaces on the next
``next()``, corrupt images are zero-filled and counted, the default
device raises without CUDA, and the JAX tests' cases of
``tests/test_io_image.py`` for these iterators."""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_records as tr
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    tr.jax_native()


N_IMAGES = 20


@pytest.fixture(scope="module")
def jpeg_rec(tmp_path_factory):
    """20 images of about 48 x 40 (sizes step by image), one corrupt."""
    path = str(tmp_path_factory.mktemp("rec") / "data.rec")
    tr.write_jpeg(path, tr.images(N_IMAGES, (48, 40), seed=0), corrupt=(6,))
    return path


@pytest.fixture(scope="module")
def grey_rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grey") / "grey.rec")
    tr.write_jpeg(path, tr.images(9, (40, 36), seed=1, channels=1))
    return path


@pytest.fixture(scope="module")
def multi_label_rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ml") / "ml.rec")
    labels = [[float(i), i * 0.5, -1.0] for i in range(10)]
    tr.write_jpeg(path, tr.images(10, (36, 44), seed=2), labels=labels)
    return path


NORM = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939, std_r=58.4,
            std_g=57.1, std_b=57.4)
CASES = {
    "plain": dict(data_shape=(3, 32, 32), batch_size=8),
    "train_imagenet_args": dict(data_shape=(3, 32, 32), batch_size=8,
                                shuffle=True, rand_mirror=True,
                                rand_crop=True, resize=36, mean_r=123.68,
                                mean_g=116.779, mean_b=103.939),
    "mean_and_std": dict(data_shape=(3, 30, 30), batch_size=6, shuffle=True,
                         rand_crop=True, resize=34, seed=7, **NORM),
    "nonsquare": dict(data_shape=(3, 24, 40), batch_size=4, rand_crop=True,
                      rand_mirror=True, resize=44, seed=3),
    "resize_below_shape": dict(data_shape=(3, 40, 40), batch_size=5,
                               resize=20, rand_crop=True),
    "part_of_three": dict(data_shape=(3, 24, 24), batch_size=3,
                          part_index=1, num_parts=3, shuffle=True),
    "round_batch_pad": dict(data_shape=(3, 16, 16), batch_size=7,
                            shuffle=True, seed=5),
    "no_round_batch": dict(data_shape=(3, 16, 16), batch_size=7,
                           round_batch=False),
    "file_smaller_than_a_batch": dict(data_shape=(3, 16, 16),
                                      batch_size=32, rand_mirror=True),
    "device_prefetch": dict(data_shape=(3, 28, 28), batch_size=8,
                            shuffle=True, device_prefetch=True,
                            rand_mirror=True),
}


def _pair(path, kw):
    j = mx.io.ImageRecordIter(path_imgrec=path, preprocess_threads=2, **kw)
    t = mt.io.ImageRecordIter(path_imgrec=path, preprocess_threads=2,
                              device=mt.cpu(), **kw)
    return j, t


def _assert_same(j, t, epochs=2):
    jb, tb = tr.batches(j, epochs), tr.batches(t, epochs)
    assert len(tb) == len(jb) > 0
    for (jd, jl, jp), (td, tl, tp) in zip(jb, tb):
        assert td.dtype == jd.dtype and td.shape == jd.shape
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
    return tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_jax(jpeg_rec, case):
    j, t = _pair(jpeg_rec, CASES[case])
    tb = _assert_same(j, t)
    assert t.provide_data[0].shape == j.provide_data[0].shape
    assert t.provide_label[0].shape == j.provide_label[0].shape
    if case == "file_smaller_than_a_batch":
        assert len(tb) == 2 and tb[0][2] == 32 - N_IMAGES
    assert len(t.wait_ms) == len(tb)


def test_grey_and_multi_value_labels_equal_jax(grey_rec, multi_label_rec):
    _assert_same(*_pair(grey_rec, dict(data_shape=(1, 32, 32), batch_size=4,
                                       rand_crop=True, resize=36,
                                       mean_r=100.0, std_r=50.0)))
    _assert_same(*_pair(multi_label_rec, dict(data_shape=(3, 32, 32),
                                              batch_size=4, label_width=3,
                                              shuffle=True)))


def test_corrupt_image_is_zero_filled_and_counted(jpeg_rec):
    """Record 6 holds no JPEG: its slot is (0 - mean) / std, as in the
    JAX package, and the port counts it."""
    j, t = _pair(jpeg_rec, dict(data_shape=(3, 32, 32), batch_size=10,
                                **NORM))
    tb = _assert_same(j, t, epochs=1)
    want = (0 - np.float32(123.68)) * (np.float32(1) / np.float32(58.4))
    assert tb[0][0][6, 0, 0, 0] == want
    assert t.decode_failures == 1


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=True, rand_mirror=True, shuffle=True, seed=7),
    dict(part_index=0, num_parts=2, batch_size=4),
])
def test_uint8_batches_equal_jax(tmp_path, layout, kw):
    path = str(tmp_path / "raw.rec")
    tr.write_raw(path, 11)
    kw = dict(dict(data_shape=(3, 32, 32), batch_size=3), **kw)
    j = mx.io.ImageRecordUInt8Iter(path_imgrec=path, output_layout=layout,
                                   **kw)
    t = mt.io.ImageRecordUInt8Iter(path_imgrec=path, output_layout=layout,
                                   device=mt.cpu(), **kw)
    tb = _assert_same(j, t)
    assert tb[0][0].dtype == np.uint8
    assert tuple(t.provide_data[0].shape) == tuple(j.provide_data[0].shape)
    assert t.provide_data[0].layout == j.provide_data[0].layout


def test_uint8_nonsquare_stored_shape_equals_jax(tmp_path):
    path = str(tmp_path / "raw.rec")
    tr.write_raw(path, 6, shape=(30, 44))
    kw = dict(data_shape=(3, 24, 40), batch_size=4, stored_shape=(30, 44),
              rand_crop=True, rand_mirror=True, seed=2)
    _assert_same(mx.io.ImageRecordUInt8Iter(path_imgrec=path, **kw),
                 mt.io.ImageRecordUInt8Iter(path_imgrec=path,
                                            device=mt.cpu(), **kw))


def test_uint8_iter_center_crop_and_refusals(tmp_path):
    """The JAX test's cases: a centre crop is the stored image's middle,
    identity mean and std are accepted, any other refused, and a layout
    other than NCHW or NHWC too."""
    path = str(tmp_path / "raw.rec")
    imgs = tr.write_raw(path, 6)
    it = mt.io.ImageRecordUInt8Iter(path_imgrec=path, data_shape=(3, 32, 32),
                                    batch_size=3, device=mt.cpu(),
                                    mean_r=0.0, std_r=1.0)
    d, lab, pad = it.next_raw()
    assert d.dtype == np.uint8 and pad == 0
    np.testing.assert_array_equal(d[0], imgs[0][4:36, 4:36].transpose(2, 0,
                                                                         1))
    np.testing.assert_array_equal(lab, [0.0, 1.0, 2.0])
    with pytest.raises(mt.MXNetError, match="on device"):
        mt.io.ImageRecordUInt8Iter(path_imgrec=path, data_shape=(3, 32, 32),
                                   batch_size=3, device=mt.cpu(), std_r=58.4)
    with pytest.raises(mt.MXNetError, match="NCHW or NHWC"):
        mt.io.ImageRecordUInt8Iter(path_imgrec=path, data_shape=(3, 32, 32),
                                   batch_size=3, device=mt.cpu(),
                                   output_layout="CHWN")


def test_producer_error_surfaces_on_next(tmp_path):
    """A record of the wrong size fails the producer thread; the consumer
    sees it at its next ``next()``, and the epoch ends there."""
    path = str(tmp_path / "bad.rec")
    rec = mt.recordio.MXRecordIO(path, "w")
    rec.write(mt.recordio.pack((0, 0.0, 0, 0), b"\0" * 75))
    rec.write(mt.recordio.pack((0, 1.0, 1, 0), b"\0" * 74))
    rec.close()
    it = mt.io.ImageRecordUInt8Iter(path_imgrec=path, data_shape=(3, 4, 4),
                                    batch_size=2, stored_shape=(5, 5),
                                    device=mt.cpu())
    with pytest.raises(mt.MXNetError, match="prefetch thread"):
        next(iter(it))
    with pytest.raises(StopIteration):
        it.next()


def test_device_prefetch_defers_a_failure_by_one_batch(jpeg_rec,
                                                       monkeypatch):
    """With ``device_prefetch`` batch t is handed out although t+1
    failed; the failure comes at the next call."""
    it = mt.io.ImageRecordIter(path_imgrec=jpeg_rec, data_shape=(3, 16, 16),
                               batch_size=4, device=mt.cpu(),
                               device_prefetch=True)
    calls = {"n": 0}
    real = it._next_item

    def flaky():
        calls["n"] += 1
        if calls["n"] == 2:
            raise mt.MXNetError("injected")
        return real()
    monkeypatch.setattr(it, "_next_item", flaky)
    first = it.next()
    assert first.data[0].shape == (4, 3, 16, 16)
    with pytest.raises(mt.MXNetError, match="injected"):
        it.next()


def test_default_device_raises_without_cuda(jpeg_rec):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        mt.io.ImageRecordIter(path_imgrec=jpeg_rec, data_shape=(3, 16, 16),
                              batch_size=4)
    with mt.cpu():
        it = mt.io.ImageRecordIter(path_imgrec=jpeg_rec,
                                   data_shape=(3, 16, 16), batch_size=4)
    assert it.next().data[0].context.device_type == "cpu"


def test_names_and_aliases():
    assert mt.io.ImageRecordIter_v1 is mt.io.ImageRecordIter \
        is mt.ImageRecordIter is mt.image_record_iter.ImageRecordIter
    assert mt.io.ImageRecordUInt8Iter_v1 is mt.io.ImageRecordUInt8Iter \
        is mt.ImageRecordUInt8Iter
    assert mt.io.ImageDetRecordIter is mt.ImageDetRecordIter \
        is mt.image.ImageDetRecordIter
    assert mt.img is mt.image


def test_record_iter_trains_a_module_on_the_cpu(jpeg_rec):
    """``Module.fit`` from the iterator, as train_imagenet.py feeds it,
    through a reset at the epoch's end."""
    it = mt.io.ImageRecordIter(path_imgrec=jpeg_rec, data_shape=(3, 16, 16),
                               batch_size=8, shuffle=True, rand_crop=True,
                               rand_mirror=True, resize=20, device=mt.cpu(),
                               **NORM)
    S = mt.sym
    net = S.SoftmaxOutput(S.FullyConnected(S.Flatten(S.Variable("data")),
                                           num_hidden=7, name="fc"),
                          name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    metric = mt.metric.create("acc")
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01},
            initializer=mt.init.Xavier(), eval_metric=metric)
    assert np.isfinite(mod.get_params()[0]["fc_weight"].asnumpy()).all()
    assert len(it.wait_ms) == 6
