"""Checkpoints and the training helpers of the ResNet recipe in the
PyTorch port, against the JAX package: NDArray files (``nd.save`` /
``nd.load``), ``save_checkpoint`` / ``load_checkpoint`` with the symbol
JSON, optimizer states, ``Module.load`` resuming a run, ``do_checkpoint``,
the learning-rate schedulers, ``TopKAccuracy`` and ``run_steps``.

Files must agree byte for byte and arrays bit for bit.  A step taken by
the other package after a resume agrees within 1e-4 of the largest value
of its kind (both compute in f32 in another summation order, at batch 2,
where the JAX package's CPU reductions stay accurate; see
``tests/test_torch_resnet_train.py``).  Schedulers are host arithmetic
and must agree exactly; metrics too."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models.resnet import resnet as j_resnet

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.resnet import resnet as t_resnet
import torch_threads  # noqa: F401,E402  a worker's share of the cores

B, SHAPE = 2, (3, 28, 28)
NET = dict(units=[1, 1, 1], num_stages=3, filter_list=[8, 8, 16, 32],
           num_classes=10, image_shape=SHAPE, bottle_neck=False)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RTOL = 1e-4


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"f32": rng.randn(3, 4).astype(np.float32),
            "bf16": rng.randn(5).astype(np.float32),
            "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
            "scalar": np.array(2.5, np.float32)}


def _jax_nd(name, v):
    return mx.nd.NDArray(jnp.asarray(v, jnp.bfloat16 if name == "bf16"
                                     else v.dtype))


def _torch_nd(name, v):
    t = torch.from_numpy(v.copy())
    return mt.nd.NDArray(t.to(torch.bfloat16) if name == "bf16" else t)


def _numpy(arr):
    """An NDArray of either package as numpy, bf16 widened to f32."""
    data = arr._data
    if isinstance(data, torch.Tensor):
        return data.float().numpy() if data.dtype == torch.bfloat16 \
            else data.numpy()
    return np.asarray(data.astype(jnp.float32) if data.dtype == jnp.bfloat16
                      else data)


def _dtype_name(arr):
    return str(arr.dtype).replace("torch.", "")


@pytest.mark.parametrize("container", ["list", "dict"])
def test_nd_files_are_byte_identical_and_load_across(tmp_path, container):
    vals = _arrays()
    names = sorted(vals)
    jdata = {n: _jax_nd(n, vals[n]) for n in names}
    tdata = {n: _torch_nd(n, vals[n]) for n in names}
    if container == "list":
        jdata, tdata = [jdata[n] for n in names], [tdata[n] for n in names]
    jfile, tfile = str(tmp_path / "j.nd"), str(tmp_path / "t.nd")
    mx.nd.save(jfile, jdata)
    mt.nd.save(tfile, tdata)
    with open(jfile, "rb") as f1, open(tfile, "rb") as f2:
        assert f1.read() == f2.read()
    for src, dst_pkg, want in ((jfile, mt, tdata), (tfile, mx, jdata)):
        got = dst_pkg.nd.load(src)
        assert type(got) is type(want)
        keys = range(len(names)) if container == "list" else names
        for k in keys:
            assert got[k].shape == want[k].shape
            assert _dtype_name(got[k]._data) == _dtype_name(want[k]._data)
            np.testing.assert_array_equal(_numpy(got[k]), _numpy(want[k]))


def test_load_refuses_another_format(tmp_path):
    """A file of neither package's format is refused; one that starts
    as the reference MXNet's container (its magic 0x112) goes to that
    reader (C4), which refuses it when it is cut short."""
    path = str(tmp_path / "x.params")
    with open(path, "wb") as f:
        f.write(b"\x13\x01\x00\x00\x00\x00\x00\x00rest")
    with pytest.raises(mt.MXNetError, match="not an mxnet_tpu NDArray"):
        mt.nd.load(path)
    with open(path, "wb") as f:
        f.write(b"\x12\x01\x00\x00\x00\x00\x00\x00rest")
    with pytest.raises(mt.MXNetError, match="truncated"):
        mt.nd.load(path)


def _params(net, seed=0):
    arg_shapes, _, aux_shapes = net.infer_shape(data=(B,) + SHAPE,
                                                softmax_label=(B,))
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                if n.endswith("_weight") else 1 + rng.randn(*s) * 0.1
                if n.endswith("_gamma") else rng.randn(*s) * 0.1)
            .astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-1, 1, (B,) + SHAPE).astype(np.float32),
             rng.randint(0, 10, (B,)).astype(np.float32)) for _ in range(n)]


def _module(pkg, net, args=None, aux=None):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (B,) + SHAPE)],
             label_shapes=[("softmax_label", (B,))])
    if args is not None:
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in args.items()},
                        aux_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in aux.items()})
    return mod


def _step(pkg, mod, x, y):
    ctx = pkg.cpu()
    mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)]), is_train=True)
    mod.backward()
    mod.update()


def _eval(pkg, mod, x, y):
    ctx = pkg.cpu()
    mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)]), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def _state(pkg, mod):
    """(args, aux, momenta) of a module as numpy dicts."""
    a, x = mod.get_params()
    states = mod._opt_states if pkg is mx else mod._updater.states
    return ({n: v.asnumpy() for n, v in a.items()},
            {n: v.asnumpy() for n, v in x.items()},
            {n: st[0].asnumpy() for n, st in states.items()})


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        scale = max(float(np.abs(v).max()) for v in w.values())
        for n in w:
            assert np.abs(g[n] - w[n]).max() <= RTOL * scale, n


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_with_symbol_loads_across(tmp_path, direction):
    """``save_checkpoint`` of one package, ``load_checkpoint`` of the
    other: the symbol JSON builds the same network, and the loaded
    parameters give the same inference output as the originals."""
    src, dst = (mx, mt) if direction == "jax_to_port" else (mt, mx)
    build = {mx: j_resnet, mt: t_resnet}
    net = build[src](**NET)
    args, aux = _params(net)
    prefix = str(tmp_path / "ck")
    src.model.save_checkpoint(prefix, 3, net,
                              {n: src.nd.array(v, ctx=src.cpu())
                               for n, v in args.items()},
                              {n: src.nd.array(v, ctx=src.cpu())
                               for n, v in aux.items()})
    sym, largs, laux = dst.model.load_checkpoint(prefix, 3)
    assert sym.list_arguments() == net.list_arguments()
    assert sym.list_auxiliary_states() == net.list_auxiliary_states()
    for given, loaded in ((args, largs), (aux, laux)):
        assert set(given) == set(loaded)
        for n in given:
            np.testing.assert_array_equal(loaded[n].asnumpy(), given[n])
    x, y = _batches(1)[0]
    want = _eval(dst, _module(dst, build[dst](**NET), args, aux), x, y)
    mod = dst.mod.Module(sym, context=dst.cpu())
    mod.bind(data_shapes=[("data", (B,) + SHAPE)],
             label_shapes=[("softmax_label", (B,))], for_training=False)
    mod.set_params(largs, laux)
    np.testing.assert_array_equal(_eval(dst, mod, x, y), want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(tmp_path, direction):
    """One package trains 2 SGD-momentum steps and checkpoints with its
    optimizer states; the other resumes with ``Module.load(...,
    load_optimizer_states=True)``: parameters, moving statistics and
    momenta arrive bit for bit, and the next step agrees with the first
    package's own next step."""
    src, dst = (mx, mt) if direction == "jax_to_port" else (mt, mx)
    build = {mx: j_resnet, mt: t_resnet}
    args, aux = _params(build[src](**NET))
    batches = _batches(3)
    mod = _module(src, build[src](**NET), args, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    for x, y in batches[:2]:
        _step(src, mod, x, y)
    prefix = str(tmp_path / "run")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    saved = _state(src, mod)
    _step(src, mod, *batches[2])
    want = _state(src, mod)

    res = dst.mod.Module.load(prefix, 2, load_optimizer_states=True,
                              context=dst.cpu())
    res.bind(data_shapes=[("data", (B,) + SHAPE)],
             label_shapes=[("softmax_label", (B,))])
    res.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    for got, exp in zip(_state(dst, res), saved):
        assert set(got) == set(exp)
        for n in exp:
            np.testing.assert_array_equal(got[n], exp[n])
    _step(dst, res, *batches[2])
    _assert_close(_state(dst, res), want)


def test_port_resume_equals_uninterrupted_run(tmp_path):
    """In the port alone, a run checkpointed after 2 steps and resumed
    through ``Module.load`` takes the third step bit for bit as the
    uninterrupted run does."""
    net = t_resnet(**NET)
    args, aux = _params(net)
    batches = _batches(3)
    mod = _module(mt, net, args, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    prefix = str(tmp_path / "run")
    for i, (x, y) in enumerate(batches):
        if i == 2:
            mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
        _step(mt, mod, x, y)
    res = mt.mod.Module.load(prefix, 2, load_optimizer_states=True,
                             context=mt.cpu())
    res.bind(data_shapes=[("data", (B,) + SHAPE)],
             label_shapes=[("softmax_label", (B,))])
    res.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    _step(mt, res, *batches[2])
    for got, exp in zip(_state(mt, res), _state(mt, mod)):
        for n in exp:
            np.testing.assert_array_equal(got[n], exp[n])


def test_fit_do_checkpoint_and_load_params(tmp_path):
    """``fit`` with ``do_checkpoint`` writes the symbol and one params
    file per epoch, and ``load_params`` / ``begin_epoch`` pick them up;
    ``module_checkpoint`` writes the optimizer states too."""
    net = t_resnet(**NET)
    args, aux = _params(net)
    x = np.concatenate([b[0] for b in _batches(2)])
    y = np.concatenate([b[1] for b in _batches(2)])
    prefix = str(tmp_path / "fit")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=B), num_epoch=2,
            arg_params=args, aux_params=aux, optimizer="sgd",
            optimizer_params=OPT, eval_metric="acc",
            epoch_end_callback=[mt.callback.do_checkpoint(prefix),
                                mt.callback.module_checkpoint(
                                    mod, prefix + "-m", 2, True)])
    for name in ("fit-symbol.json", "fit-0001.params", "fit-0002.params",
                 "fit-m-symbol.json", "fit-m-0002.params",
                 "fit-m-0002.states"):
        assert os.path.exists(str(tmp_path / name)), name
    other = _module(mt, t_resnet(**NET))
    other.load_params(prefix + "-0002.params")
    for got, exp in zip(other.get_params(), mod.get_params()):
        assert set(got) == set(exp)
        for n in exp:
            np.testing.assert_array_equal(got[n].asnumpy(),
                                          exp[n].asnumpy())
    # a later fit picks up at begin_epoch from the loaded parameters
    _, a2, x2 = mt.model.load_checkpoint(prefix, 2)
    mod2 = mt.mod.Module(net, context=mt.cpu())
    mod2.fit(mt.io.NDArrayIter(x, y, batch_size=B), begin_epoch=2,
             num_epoch=3, arg_params=a2, aux_params=x2, optimizer="sgd",
             optimizer_params=OPT,
             epoch_end_callback=mt.callback.do_checkpoint(prefix))
    assert os.path.exists(str(tmp_path / "fit-0003.params"))
    assert not os.path.exists(str(tmp_path / "fit-0004.params"))


def _schedules():
    return [
        ("MultiFactorScheduler", dict(step=[30, 120, 250], factor=0.5)),
        ("FactorScheduler", dict(step=40, factor=0.7, stop_factor_lr=1e-3)),
        ("PolyScheduler", dict(max_update=250, base_lr=0.2, pwr=2)),
        ("CosineScheduler", dict(max_update=250, base_lr=0.3,
                                 final_lr=0.01, warmup_steps=20,
                                 warmup_begin_lr=0.05)),
    ]


@pytest.mark.parametrize("name,kw", _schedules())
def test_lr_schedulers_match_jax(name, kw):
    j = getattr(mx.lr_scheduler, name)(**kw)
    t = getattr(mt.lr_scheduler, name)(**kw)
    if name in ("MultiFactorScheduler", "FactorScheduler"):
        j.base_lr = t.base_lr = 0.4
    got = [t(i) for i in range(0, 300)]
    want = [j(i) for i in range(0, 300)]
    assert got == want
    assert len(set(got)) > 3


def test_lr_scheduler_drives_the_optimizer():
    sched = mt.lr_scheduler.MultiFactorScheduler(step=[2, 4], factor=0.1)
    opt = mt.optimizer.create("sgd", learning_rate=1.0, lr_scheduler=sched)
    lrs = []
    for _ in range(6):
        opt._update_count(0)
        lrs.append(opt._get_lr(0))
    np.testing.assert_allclose(lrs, [1, 1, .1, .1, .01, .01])


@pytest.mark.parametrize("top_k", [2, 3, 5])
def test_top_k_accuracy_matches_jax(top_k):
    rng = np.random.RandomState(top_k)
    pred = rng.randn(12, 6).astype(np.float32)
    pred[0, :] = 1.0                       # all tied: lower ids win
    pred[1, 2] = pred[1, 4] = 9.0          # tie at the top
    pred[2, 3] = np.nan                    # NaN ranks first
    label = rng.randint(0, 6, 12).astype(np.float32)
    label[0], label[1], label[2] = 1, 4, 3
    jm = mx.metric.create("top_k_accuracy", top_k=top_k)
    tm = mt.metric.create("top_k_accuracy", top_k=top_k)
    for _ in range(2):
        jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
        tm.update([label], [torch.from_numpy(pred)])
    assert tm.get() == jm.get()
    assert tm.get()[0] == "top_k_accuracy_%d" % top_k
    assert isinstance(mt.metric.create("top_k_acc", top_k=2),
                      mt.metric.TopKAccuracy)


def test_run_steps_equals_single_steps():
    """``run_steps(k=3)`` over stacked batches gives the parameters,
    moving statistics and momenta of 3 single steps bit for bit, and the
    outputs of each step stacked."""
    net = t_resnet(**NET)
    args, aux = _params(net)
    batches = _batches(3)
    single = _module(mt, net, args, aux)
    single.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    outs = []
    for x, y in batches:
        _step(mt, single, x, y)
        outs.append(single.get_outputs()[0].asnumpy())
    multi = _module(mt, net, args, aux)
    multi.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    metric = mt.metric.Accuracy()
    stacked = multi.run_steps(np.stack([b[0] for b in batches]),
                              np.stack([b[1] for b in batches]), k=3,
                              eval_metric=metric)
    assert len(stacked) == 1 and stacked[0].shape == (3, B, 10)
    np.testing.assert_array_equal(stacked[0].asnumpy(), np.stack(outs))
    for got, exp in zip(_state(mt, multi), _state(mt, single)):
        for n in exp:
            np.testing.assert_array_equal(got[n], exp[n])
    assert metric.get()[1] == np.mean([
        (o.argmax(1) == b[1]).mean() for o, b in zip(outs, batches)])
    with pytest.raises(mt.MXNetError, match="k=2"):
        multi.run_steps(np.stack([b[0] for b in batches]),
                        np.stack([b[1] for b in batches]), k=2)
