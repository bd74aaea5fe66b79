"""``gluon.data`` in the PyTorch port against the JAX package: datasets,
samplers and the ``DataLoader`` give the same batches from the same
``np.random.seed`` (the shuffle draws from numpy's global generator in
both), in every ``last_batch`` mode, serially and with worker threads.
Batches are copies of the inputs, so they are compared exactly.

The port's own contract: a worker thread does not see the caller's
thread-local ``with mt.cpu():``, so the loader takes the caller's context
and puts every batch there; without a context, batches go to ``gpu(0)``
and raise without CUDA; the vision datasets read local files only."""
import gzip
import os
import struct
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def _batches(pkg, seed, *args, **kw):
    """Every batch of one epoch as numpy (tuples of fields)."""
    np.random.seed(seed)
    loader = pkg.gluon.data.DataLoader(pkg.gluon.data.ArrayDataset(*args),
                                       **kw)
    out = []
    for b in loader:
        fields = b if isinstance(b, list) else [b]
        out.append(tuple(f.asnumpy() for f in fields))
    return out, len(loader)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def test_dataset_dataloader():
    """The JAX package's ``test_gluon.py::test_dataset_dataloader``
    through both packages."""
    X = np.arange(40, dtype="float32").reshape(10, 4)
    Y = np.arange(10, dtype="float32")
    for pkg in (mx, mt):
        ds = pkg.gluon.data.ArrayDataset(X, Y)
        assert len(ds) == 10
        batches = list(pkg.gluon.data.DataLoader(ds, batch_size=3,
                                                 last_batch="keep"))
        assert len(batches) == 4
        xb, yb = batches[0]
        assert xb.shape == (3, 4) and yb.shape == (3,)
        assert len(list(pkg.gluon.data.DataLoader(
            ds, batch_size=3, last_batch="discard"))) == 3
        x0, y0 = ds.transform_first(lambda x: x * 2)[0]
        np.testing.assert_allclose(np.asarray(x0), X[0] * 2)
    _same_batches(_batches(mx, 0, X, Y, batch_size=3)[0],
                  _batches(mt, 0, X, Y, batch_size=3)[0])


def test_dataloader_shuffle_and_workers():
    """``test_gluon.py::test_dataloader_shuffle_and_workers``: a shuffled
    epoch over 2 workers holds every sample once, and the port's batches
    equal the JAX package's from the same seed."""
    X = np.arange(100, dtype="float32").reshape(50, 2)
    kw = dict(batch_size=10, shuffle=True, num_workers=2)
    j, _ = _batches(mx, 3, X, **kw)
    t, _ = _batches(mt, 3, X, **kw)
    seen = np.concatenate([b[0][:, 0] for b in t])
    assert sorted(seen.tolist()) == sorted(X[:, 0].tolist())
    _same_batches(j, t)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_last_batch_modes_match_jax(last_batch, workers):
    """23 samples in batches of 5 over two epochs of one loader: ``keep``
    ends each epoch with 3, ``discard`` drops them, ``rollover`` opens the
    next epoch with them; ``len`` follows."""
    X = np.random.RandomState(0).randn(23, 3).astype(np.float32)
    Y = np.arange(23).astype(np.int32)
    got = {}
    for pkg in (mx, mt):
        np.random.seed(5)
        loader = pkg.gluon.data.DataLoader(
            pkg.gluon.data.ArrayDataset(X, Y), batch_size=5, shuffle=True,
            last_batch=last_batch, num_workers=workers)
        epochs = []
        for _ in range(2):
            n = len(loader)
            epochs.append((n, [tuple(f.asnumpy() for f in b)
                               for b in loader]))
        got[pkg] = epochs
    for (jn, jb), (tn, tb) in zip(got[mx], got[mt]):
        assert jn == tn
        _same_batches(jb, tb)
    sizes = [len(b[0]) for b in got[mt][0][1]]
    assert sizes == {"keep": [5, 5, 5, 5, 3], "discard": [5] * 4,
                     "rollover": [5] * 4}[last_batch]
    if last_batch == "rollover":
        assert len(got[mt][1][1]) == 5          # 3 rolled over + 22 -> 5


def test_samplers_match_jax():
    for pkg_s in ("SequentialSampler", "RandomSampler"):
        got = []
        for pkg in (mx, mt):
            np.random.seed(11)
            got.append(list(getattr(pkg.gluon.data, pkg_s)(17)))
        assert got[0] == got[1]
    jb = list(mx.gluon.data.BatchSampler(
        mx.gluon.data.SequentialSampler(7), 3, "keep"))
    tb = list(mt.gluon.data.BatchSampler(
        mt.gluon.data.SequentialSampler(7), 3, "keep"))
    assert jb == tb == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(ValueError):
        list(mt.gluon.data.BatchSampler(mt.gluon.data.SequentialSampler(7),
                                        3, "bogus"))


def test_transforms_and_simple_dataset():
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    Y = np.arange(6, dtype=np.float32)
    for lazy in (True, False):
        got = []
        for pkg in (mx, mt):
            ds = pkg.gluon.data.ArrayDataset(X, Y)
            t = ds.transform(lambda x, y: (x + 1, y * 3), lazy=lazy)
            f = ds.transform_first(lambda x: -x, lazy=lazy)
            got.append([(np.asarray(t[i][0]), t[i][1], np.asarray(f[i][0]))
                        for i in range(len(ds))])
        for (a, b, c), (d, e, f) in zip(*got):
            np.testing.assert_array_equal(a, d)
            assert b == e
            np.testing.assert_array_equal(c, f)
    s = mt.gluon.data.SimpleDataset([1, 2, 3])
    assert len(s) == 3 and s[1] == 2


def test_ndarray_samples_stack_on_their_device():
    """NDArray samples are stacked as tensors (the JAX package goes
    through ``asnumpy`` a sample); the batch equals the JAX package's."""
    X = np.random.RandomState(1).randn(8, 2, 3).astype(np.float32)
    jds = mx.gluon.data.SimpleDataset([mx.nd.array(x) for x in X])
    tds = mt.gluon.data.SimpleDataset([mt.nd.array(x) for x in X])
    j = [b.asnumpy() for b in mx.gluon.data.DataLoader(jds, batch_size=4)]
    t = [b.asnumpy() for b in mt.gluon.data.DataLoader(tds, batch_size=4)]
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    out = mt.gluon.data.default_batchify_fn([mt.nd.array(x) for x in X[:2]])
    assert out.shape == (2, 2, 3) and out.context == mt.cpu()


def test_workers_put_batches_on_the_callers_context():
    """Worker threads do not see the caller's ``with mt.cpu():``; every
    batch still lands on the CPU, and a custom ``batchify_fn`` in a worker
    runs inside the caller's context."""
    X = np.arange(40, dtype=np.float32).reshape(20, 2)
    Y = np.arange(20, dtype=np.float32)
    workers = set()

    def batchify(samples):
        workers.add(threading.get_ident())
        return mt.nd.array(np.stack([s[0] for s in samples]))
    ds = mt.gluon.data.ArrayDataset(X, Y)
    for kw in ({}, {"batchify_fn": batchify}):
        loader = mt.gluon.data.DataLoader(ds, batch_size=4, num_workers=2,
                                          **kw)
        for b in loader:
            for f in (b if isinstance(b, list) else [b]):
                assert f.context == mt.cpu()
    assert workers and threading.get_ident() not in workers


def test_without_a_context_batches_go_to_the_gpu():
    """No silent CPU: outside ``with mt.cpu():`` the loader targets
    ``gpu(0)``, which raises on a machine without CUDA."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    ds = mt.gluon.data.ArrayDataset(np.zeros((4, 2), np.float32))
    box = {}

    def run():
        try:
            next(iter(mt.gluon.data.DataLoader(ds, batch_size=2)))
        except mt.MXNetError as e:
            box["err"] = e
    t = threading.Thread(target=run)     # a thread has no cpu() scope
    t.start()
    t.join()
    assert "CUDA is not available" in str(box["err"])


def test_record_datasets_raise_naming_c3(tmp_path):
    """The record datasets raised naming C3 until data IO was ported; now
    they open a record file (``tests/test_torch_image.py`` holds them
    against the JAX package) and a missing one raises as a file does."""
    for cls in (mt.gluon.data.RecordFileDataset,
                mt.gluon.data.vision.ImageRecordDataset):
        with pytest.raises(FileNotFoundError):
            cls(str(tmp_path / "x.rec"))
    rec = mt.recordio.MXIndexedRecordIO(str(tmp_path / "y.idx"),
                                        str(tmp_path / "y.rec"), "w")
    rec.write_idx(0, mt.recordio.pack(mt.recordio.IRHeader(0, 3.0, 0, 0),
                                      b"abc"))
    rec.close()
    ds = mt.gluon.data.RecordFileDataset(str(tmp_path / "y.rec"))
    assert len(ds) == 1
    header, payload = mt.recordio.unpack(ds[0])
    assert header.label == 3.0 and payload == b"abc"


def _write_mnist(root, n=7, gz=False):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    with op(os.path.join(root, "train-images-idx3-ubyte" + sfx), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with op(os.path.join(root, "train-labels-idx1-ubyte" + sfx), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_mnist_and_cifar_from_local_files_match_jax(tmp_path, gz):
    _write_mnist(str(tmp_path), gz=gz)
    rng = np.random.RandomState(3)
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    for i in range(1, 6):
        rec = np.concatenate([rng.randint(0, 10, (4, 1)),
                              rng.randint(0, 256, (4, 3072))], 1)
        (cifar / f"data_batch_{i}.bin").write_bytes(
            rec.astype(np.uint8).tobytes())
    for cls, root in (("MNIST", tmp_path), ("FashionMNIST", tmp_path),
                      ("CIFAR10", cifar)):
        j = getattr(mx.gluon.data.vision, cls)(root=str(root))
        t = getattr(mt.gluon.data.vision, cls)(root=str(root))
        assert len(j) == len(t)
        for i in range(len(t)):
            (jx, jy), (tx, ty) = j[i], t[i]
            assert tx.dtype == np.uint8 and tx.shape == jx.shape
            np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
            assert int(ty) == int(jy)
        batch = next(iter(mt.gluon.data.DataLoader(t, batch_size=4)))
        assert batch[0].shape == (4,) + jx.shape
    with pytest.raises(mt.MXNetError, match="no network egress"):
        mt.gluon.data.vision.MNIST(root=str(tmp_path / "empty"))
    with pytest.raises(mt.MXNetError, match="no network egress"):
        mt.gluon.data.vision.CIFAR10(root=str(tmp_path / "empty"),
                                     train=False)
