"""Sharded and asynchronous checkpoints and the reference MXNet's own
``.params`` files in the PyTorch port, against the JAX package (the
cases of ``tests/test_checkpoint.py``).

Every comparison is bit for bit (tolerance 0): a checkpoint moves bytes,
it computes nothing.  A tokenless sharded save must equal the golden
files byte for byte; the single-file, sharded and reference formats
written by either package (bf16 included) must load in the other to the
same bits; a run resumed from a checkpoint must repeat the uninterrupted
run exactly (the CPU is deterministic for these ops).  Every wait on a
background write has a timeout of its own."""
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as jck
from mxnet_tpu import compat_serialization as jcompat

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch import compat_serialization as tcompat
import torch_threads  # noqa: F401,E402  a worker's share of the cores

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
WAIT_S = 60.0      # the longest any background write may take here


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data(n=120, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype("f")
    Y = (X[:, 0] * X[:, 1] > 0).astype("f")
    return X, Y


def _values(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 6).astype(np.float32),
            "bf16": rng.randn(2, 5).astype(np.float32),
            "i32": rng.randint(-9, 9, (3,)).astype(np.int32),
            "i64": np.arange(7, dtype=np.int64),
            "u8": rng.randint(0, 255, (3, 2)).astype(np.uint8)}


def _jax_nd(name, v):
    return mx.nd.NDArray(jnp.asarray(v, jnp.bfloat16 if name == "bf16"
                                     else v.dtype))


def _torch_nd(name, v):
    t = torch.from_numpy(v.copy())
    return mt.nd.NDArray(t.to(torch.bfloat16) if name == "bf16" else t)


def _bits(arr):
    """(dtype name, raw bytes) of an NDArray of either package."""
    data = arr._data
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bfloat16:
            return "bfloat16", data.view(torch.int16).numpy().tobytes()
        a = data.numpy()
        return str(a.dtype), a.tobytes()
    a = np.asarray(data)
    return str(a.dtype), a.tobytes()


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert _bits(a[k]) == _bits(b[k]), k
        assert tuple(a[k].shape) == tuple(b[k].shape), k


# -- the sharded format ------------------------------------------------------
def test_sync_save_equals_the_golden_files_byte_for_byte(tmp_path):
    golden = np.arange(24, dtype=np.float32).reshape(4, 6)
    prefix = str(tmp_path / "g.params")
    tck.save_params_sharded(prefix, {"w": mt.nd.array(golden)})
    base = os.path.join(GOLDEN, "golden_sharded.params")
    for ext in (".index", ".shard0"):
        with open(prefix + ext, "rb") as f, open(base + ext, "rb") as g:
            assert f.read() == g.read(), ext
    loaded = tck.load_params_sharded(base)
    np.testing.assert_array_equal(loaded["w"].asnumpy(), golden)
    assert loaded["w"].context == mt.cpu()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_round_trip(tmp_path, dtype):
    a = mt.nd.array(np.linspace(-2, 2, 32).astype("f").reshape(4, 8))
    if dtype == "bfloat16":
        a = a.astype("bfloat16")
    params = {"w": a, "b": mt.nd.array(np.array([1.5, -2.0], "f"))}
    tck.save_params_sharded(str(tmp_path / "p"), params)
    _same(tck.load_params_sharded(str(tmp_path / "p")), params)
    with open(str(tmp_path / "p.index")) as f:
        assert f'"dtype": "{dtype}"' in f.read()   # numpy's names


def test_sharded_checkpoint_with_symbol_and_aux(tmp_path):
    prefix = str(tmp_path / "model")
    args = {"fc1_weight": mt.nd.array(np.ones((8, 4), "f"))}
    aux = {"stat": mt.nd.array(np.zeros((2,), "f"))}
    tck.save_checkpoint_sharded(prefix, 3, _mlp(mt), args, aux)
    s2, a2, x2 = tck.load_checkpoint_sharded(prefix, 3)
    assert s2.list_arguments() == _mlp(mt).list_arguments()
    _same(a2, args)
    _same(x2, aux)
    # load_serving_params reads either flavour
    s3, a3, x3 = tck.load_serving_params(prefix, 3)
    _same(a3, args)
    mt.model.save_checkpoint(prefix + "_single", 3, _mlp(mt), args, aux)
    s4, a4, x4 = tck.load_serving_params(prefix + "_single", 3)
    _same(a4, args)
    _same(x4, aux)


@pytest.mark.parametrize("flavour", ["sync", "async"])
def test_sharded_files_load_bit_for_bit_across_packages(tmp_path, flavour):
    vals = _values(1)
    jp = {k: _jax_nd(k, v) for k, v in vals.items()}
    tp = {k: _torch_nd(k, v) for k, v in vals.items()}
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    if flavour == "sync":
        jck.save_params_sharded(jpath, jp)
        tck.save_params_sharded(tpath, tp)
        for ext in (".index", ".shard0"):   # the same bytes
            with open(jpath + ext, "rb") as f, open(tpath + ext, "rb") as g:
                assert f.read() == g.read(), ext
    else:
        jc, tc = jck.AsyncCheckpointer(), tck.AsyncCheckpointer()
        jc.save_params(jpath, jp)
        tc.save_params(tpath, tp)
        jc.wait()
        tc.wait(timeout=WAIT_S)
    _same(tck.load_params_sharded(jpath), tp)
    _same(jck.load_params_sharded(tpath), jp)
    _same(tck.load_params_sharded(tpath), jck.load_params_sharded(jpath))


def test_single_file_format_across_packages(tmp_path):
    vals = _values(2)
    jpath, tpath = str(tmp_path / "j.nd"), str(tmp_path / "t.nd")
    mx.nd.save(jpath, {k: _jax_nd(k, v) for k, v in vals.items()})
    mt.nd.save(tpath, {k: _torch_nd(k, v) for k, v in vals.items()})
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    _same(mt.nd.load(jpath), mx.nd.load(tpath))


def test_multi_rank_group_is_refused_naming_d1(tmp_path, monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    p = {"w": mt.nd.array(np.ones(3, "f"))}
    with pytest.raises(mt.MXNetError, match="D1"):
        tck.save_params_sharded(str(tmp_path / "x"), p)
    with pytest.raises(mt.MXNetError, match="D1"):
        tck.AsyncCheckpointer().save_params(str(tmp_path / "y"), p)
    assert not os.path.exists(str(tmp_path / "x.index"))


def test_rendezvous_timeout_knob(monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_RENDEZVOUS_TIMEOUT", "12.5")
    assert tck.AsyncCheckpointer()._timeout == 12.5
    assert tck.AsyncCheckpointer(timeout_s=3)._timeout == 3.0
    monkeypatch.delenv("MXNET_CKPT_RENDEZVOUS_TIMEOUT")
    assert tck.AsyncCheckpointer()._timeout == 600.0


# -- the asynchronous checkpointer -------------------------------------------
def test_async_token_rides_the_shard_and_the_index(tmp_path):
    ck = tck.AsyncCheckpointer()
    p = {"w": mt.nd.array(np.arange(6, dtype="f"))}
    ck.save_params(str(tmp_path / "a.params"), p)
    ck.save_params(str(tmp_path / "a.params"), p)   # same prefix: seq 1
    ck.wait(timeout=WAIT_S)
    _, tok, _ = tck._read_shard_header(str(tmp_path / "a.params.shard0"))
    nonce, seq = tok.split(":")
    assert len(nonce) == 32 and seq == "1"
    import json
    with open(str(tmp_path / "a.params.index")) as f:
        assert json.load(f)["token"] == tok


def test_async_snapshot_survives_in_place_writes_and_lazy_updates(
        tmp_path):
    """The snapshot is a copy: an in-place write into the very tensor it
    read (here through ``contrib.torch``, which hands the tensor over
    without a copy) and the lazy SGD steps of a row-sparse gradient that
    follow do not reach the bytes written in the background."""
    vocab, dim = 50, 4
    w0 = np.random.RandomState(0).uniform(-1, 1, (vocab, dim)).astype("f")
    w = mt.nd.array(w0.copy())   # from_numpy shares memory
    w.attach_grad(stype="row_sparse")
    opt = mt.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                           rescale_grad=1.0)
    state = opt.create_state(0, w)
    ids = mt.nd.array(np.array([3, 7, 3, 9], "f"))
    ck = tck.AsyncCheckpointer()
    path = str(tmp_path / "lazy.params")
    read = w._data
    ck.save_params(path, {"w": w})
    mt.contrib.torch.torch_function(lambda t: t.mul_(-1.0), w)
    np.testing.assert_array_equal(read.numpy(), -w0)   # in place
    for _ in range(3):
        with mt.autograd.record():
            loss = mt.nd.Embedding(ids, w, input_dim=vocab, output_dim=dim,
                                   sparse_grad=True).sum()
        loss.backward()
        opt.update(0, w, w.grad, state)
    ck.wait(timeout=WAIT_S)
    moved = w.asnumpy()
    assert not np.array_equal(moved[[3, 7, 9]], -w0[[3, 7, 9]])
    np.testing.assert_array_equal(
        tck.load_params_sharded(path)["w"].asnumpy(), w0)
    # the JAX package reads the same snapshot
    np.testing.assert_array_equal(
        jck.load_params_sharded(path)["w"].asnumpy(), w0)


def test_async_saves_are_serialized_and_errors_raise_at_wait(tmp_path):
    ck = tck.AsyncCheckpointer()
    p1 = {"w": mt.nd.array(np.arange(6, dtype="f").reshape(2, 3))}
    p2 = {"w": mt.nd.array(np.ones((2, 3), "f"))}
    ck.save_params(str(tmp_path / "a.params"), p1)
    ck.save_params(str(tmp_path / "b.params"), p2)   # joins the first
    ck.wait(timeout=WAIT_S)
    _same(tck.load_params_sharded(str(tmp_path / "a.params")), p1)
    _same(tck.load_params_sharded(str(tmp_path / "b.params")), p2)
    ck.save_params(str(tmp_path / "nodir" / "sub" / "x.params"), p1)
    with pytest.raises(OSError):
        ck.wait(timeout=WAIT_S)
    assert not ck.in_flight()
    ck.save_params(str(tmp_path / "c.params"), p2)   # still usable
    ck.wait(timeout=WAIT_S)
    _same(tck.load_params_sharded(str(tmp_path / "c.params")), p2)


def test_async_epoch_api(tmp_path):
    ck = tck.AsyncCheckpointer()
    args = {"fc1_weight": mt.nd.array(np.ones((8, 4), "f"))}
    aux = {"bn_mean": mt.nd.array(np.zeros((8,), "f"))}
    ck.save_checkpoint(str(tmp_path / "ck"), 3, _mlp(mt), args, aux)
    ck.wait(timeout=WAIT_S)
    s, a, x = tck.load_checkpoint_sharded(str(tmp_path / "ck"), 3)
    assert s is not None
    _same(a, args)
    _same(x, aux)


def _fit(pkg, it, epochs, begin=0, mod=None, cb=None, seed=11):
    if mod is None:
        pkg.random.seed(seed)
        np.random.seed(seed)
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.fit(it, num_epoch=epochs, begin_epoch=begin, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=pkg.initializer.Xavier(), epoch_end_callback=cb)
    return mod


def test_do_checkpoint_sharded_async_through_fit(tmp_path):
    X, Y = _data()
    prefix = str(tmp_path / "ack")
    cb = mt.callback.do_checkpoint(prefix, sharded_async=True)
    mod = _fit(mt, mt.io.NDArrayIter(X, Y, batch_size=30), 3, cb=cb)
    cb.checkpointer.wait(timeout=WAIT_S)
    final = mod.get_params()[0]
    s, arg, aux = tck.load_checkpoint_sharded(prefix, 3)
    assert s is not None and s.list_arguments() == _mlp(mt).list_arguments()
    _same(arg, final)
    # every epoch's checkpoint is there, and the JAX package reads them
    for epoch in (1, 2, 3):
        _, ja, _ = jck.load_checkpoint_sharded(prefix, epoch)
        _, ta, _ = tck.load_checkpoint_sharded(prefix, epoch)
        _same(ta, ja)


def test_kill_and_resume_repeats_the_uninterrupted_run(tmp_path):
    """Three epochs, an asynchronous sharded checkpoint and the
    optimizer states, the module dropped; a fresh Module from
    load_checkpoint_sharded and the states trains three more: the same
    bits as six epochs in one go."""
    X, Y = _data()
    full = _fit(mt, mt.io.NDArrayIter(X, Y, batch_size=30), 6)
    prefix = str(tmp_path / "ck")
    cb = mt.callback.do_checkpoint(prefix, sharded_async=True)
    mod_a = _fit(mt, mt.io.NDArrayIter(X, Y, batch_size=30), 3, cb=cb)
    mod_a.save_optimizer_states(prefix + "-0003.states")
    cb.checkpointer.wait(timeout=WAIT_S)
    del mod_a   # "kill"
    sym, arg, aux = tck.load_checkpoint_sharded(prefix, 3)
    it = mt.io.NDArrayIter(X, Y, batch_size=30)
    mod_b = mt.mod.Module(sym, context=mt.cpu())
    mod_b.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod_b.init_params(arg_params=arg, aux_params=aux)
    mod_b.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    mod_b.load_optimizer_states(prefix + "-0003.states")
    _fit(mt, it, 6, begin=3, mod=mod_b)
    _same(mod_b.get_params()[0], full.get_params()[0])


# -- the reference MXNet's own format ----------------------------------------
def test_legacy_v0_fixture_loads():
    """``tests/golden/legacy_ndarray.v0`` holds bytes the original
    implementation wrote: six arange(128) arrays."""
    got = mt.nd.load(os.path.join(GOLDEN, "legacy_ndarray.v0"))
    assert len(got) == 6
    for a in got:
        assert a.dtype == np.float32 and a.context == mt.cpu()
        np.testing.assert_array_equal(a.asnumpy(),
                                      np.arange(128, dtype=np.float32))
    ref = mx.nd.load(os.path.join(GOLDEN, "legacy_ndarray.v0"))
    _same(dict(enumerate(got)), dict(enumerate(ref)))


def test_reference_format_both_ways_byte_for_byte(tmp_path):
    vals = _values(3)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jcompat.save_reference_params(jpath, {k: _jax_nd(k, v)
                                          for k, v in vals.items()})
    tcompat.save_reference_params(tpath, {k: _torch_nd(k, v)
                                          for k, v in vals.items()})
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    assert tcompat.is_reference_format(tpath)
    back, jback = mt.nd.load(tpath), mx.nd.load(tpath)
    _same(back, jback)
    # bf16 is widened to f32 on save, exactly
    assert back["bf16"].dtype == np.float32
    np.testing.assert_array_equal(
        back["bf16"].asnumpy(),
        torch.from_numpy(vals["bf16"]).bfloat16().float().numpy())
    for k in ("w", "i32", "i64", "u8"):
        np.testing.assert_array_equal(back[k].asnumpy(), vals[k])
        assert back[k].dtype == vals[k].dtype, k


def test_reference_format_positional_list_and_refusals(tmp_path):
    arrs = [mt.nd.array(np.full((2, 2), i, np.float32)) for i in range(3)]
    path = str(tmp_path / "list.params")
    tcompat.save_reference_params(path, arrs)
    for back in (mt.nd.load(path), mx.nd.load(path)):
        assert isinstance(back, list) and len(back) == 3
        np.testing.assert_array_equal(back[2].asnumpy(),
                                      np.full((2, 2), 2, np.float32))
    with pytest.raises(mt.MXNetError, match="0-d"):
        tcompat.save_reference_params(
            path, [mt.nd.NDArray(torch.tensor(1.0))])
    with pytest.raises(mt.MXNetError, match="type flag"):
        tcompat.save_reference_params(
            path, [mt.nd.NDArray(torch.zeros(2, dtype=torch.int16))])


def _v2_sparse_file(path):
    """A V2 container with a row-sparse and a CSR entry, written here by
    hand from the layout of ndarray.cc:826-1010 (neither package writes
    sparse entries)."""
    def tshape(dims):
        return struct.pack("<I", len(dims)) + struct.pack(
            "<%dq" % len(dims), *dims)
    out = [struct.pack("<QQQ", 0x112, 0, 2)]
    # row_sparse (10, 3): rows 1 and 7
    rdata = np.arange(6, dtype=np.float32).reshape(2, 3)
    ridx = np.array([1, 7], np.int64)
    out += [struct.pack("<Ii", 0xF993FAC9, 1), tshape((2, 3)),
            tshape((10, 3)), struct.pack("<ii", 1, 0),
            struct.pack("<i", 0), struct.pack("<i", 6), tshape((2,)),
            rdata.tobytes(), ridx.tobytes()]
    # csr (3, 4): aux [indptr, indices]
    cdata = np.array([5, 6, 7], np.float32)
    indptr = np.array([0, 1, 1, 3], np.int64)
    indices = np.array([2, 0, 3], np.int64)
    out += [struct.pack("<Ii", 0xF993FAC9, 2), tshape((3,)),
            tshape((3, 4)), struct.pack("<ii", 1, 0),
            struct.pack("<i", 0), struct.pack("<i", 6), tshape((4,)),
            struct.pack("<i", 6), tshape((3,)), cdata.tobytes(),
            indptr.tobytes(), indices.tobytes()]
    names = [b"rsp", b"csr"]
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        out.append(struct.pack("<Q", len(n)) + n)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def test_reference_sparse_entries_load_into_the_c2_containers(tmp_path):
    path = str(tmp_path / "sparse.params")
    _v2_sparse_file(path)
    got, ref = mt.nd.load(path), mx.nd.load(path)
    assert isinstance(got["rsp"], mt.nd.sparse.RowSparseNDArray)
    assert isinstance(got["csr"], mt.nd.sparse.CSRNDArray)
    np.testing.assert_array_equal(got["rsp"].indices.asnumpy(), [1, 7])
    np.testing.assert_array_equal(got["csr"].indptr.asnumpy(), [0, 1, 1, 3])
    for k in ("rsp", "csr"):
        np.testing.assert_array_equal(got[k].todense().asnumpy(),
                                      ref[k].todense().asnumpy())


def test_module_load_of_a_reference_checkpoint_predicts_as_the_original(
        tmp_path):
    """A checkpoint whose symbol is the reference's own v0.8 JSON and
    whose parameters are in the reference's binary container loads
    through load_checkpoint and Module.load and predicts as the module
    that wrote it."""
    prefix = str(tmp_path / "legacy")
    shutil.copy(os.path.join(GOLDEN, "reference_save_000800.json"),
                prefix + "-symbol.json")
    sym = mt.sym.load(prefix + "-symbol.json")
    mod = mt.mod.Module(sym, label_names=("softmax_label",),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    mt.random.seed(3)
    mod.init_params(mt.initializer.Xavier())
    arg, aux = mod.get_params()
    blob = {("arg:%s" % k): v for k, v in arg.items()}
    blob.update({("aux:%s" % k): v for k, v in aux.items()})
    tcompat.save_reference_params(prefix + "-0007.params", blob)
    sym2, arg2, aux2 = mt.model.load_checkpoint(prefix, 7)
    assert set(arg2) == set(arg) and set(aux2) == set(aux)
    x = np.random.RandomState(1).rand(4, 10).astype("f")
    batch = mt.io.DataBatch([mt.nd.array(x)], [mt.nd.zeros((4,))])
    mod2 = mt.mod.Module.load(prefix, 7, label_names=("softmax_label",),
                              context=mt.cpu())
    mod2.bind(data_shapes=[("data", (4, 10))],
              label_shapes=[("softmax_label", (4,))], for_training=False)
    mod.forward(batch, is_train=False)
    mod2.forward(batch, is_train=False)
    np.testing.assert_array_equal(mod2.get_outputs()[0].asnumpy(),
                                  mod.get_outputs()[0].asnumpy())
    # the JAX package reads the port's reference-format checkpoint
    _, jarg, _ = mx.model.load_checkpoint(prefix, 7)
    _same(arg2, jarg)
