"""CPU rehearsals: the f32 rounding numbers behind the port's
tolerances and margins (not collected by pytest).

    JAX_PLATFORMS=cpu python tests/torch_numerics.py [part ...]

Parts (all by default; each prints JSON lines):

* ``resnet`` (about two minutes): the numbers behind
  ``tests/test_torch_resnet_train.py`` and ``chip_smoke.py``'s fp32
  ResNet check:

  - ``golden_curve``: the ResNet-20 golden loss curve
    (``tests/golden/resnet20_loss_curve.json``) against the JAX Module's
    own run, the JAX Module's run with every initial parameter moved by
    one f32 ulp, and the port's runs from the JAX initial parameters,
    plain and moved by one ulp (largest distance over the 24 losses);
  - ``digits_gradients``: the first digits batch through ResNet-20 in
    both packages, forward and gradients, each against a float64 run of
    the port (relative to the largest value);
  - ``small_batch8_gradients``: the same for a small cifar-stem ResNet at
    batch 8 of random images;
  - ``resnet50_fp32_vs_float64``: ``chip_smoke.py``'s fp32 check
    (ResNet-50, batch 4 of 128x128, the same seeded weights) in fp32
    against float64: the gradient's relative distance in norm and the
    worst single parameter's, relative to its largest element.

* ``deep_bn`` (about a minute): why ``tests/test_torch_zoo.py`` compares
  the deep BatchNorm networks' gradients on the moving statistics: a
  deep network's training gradient through batch statistics in f32,
  port and JAX package, each against the port in float64 (relative to
  the largest gradient), over seeds and sizes.

* ``gluon`` (several minutes): the numbers behind ``chip_smoke.py``'s
  Gluon phases and ``tests/test_torch_gluon_resnet.py``:

  - ``train``: the ``gluon_resnet_train`` loop (resnet50_v1 at full
    depth and width, ``gluon.Trainer`` SGD lr 0.1 momentum 0.9 wd 1e-4,
    Xavier gaussian magnitude 2, two synthetic batches in turn) on the
    CPU, hybridized, fp32, batch 16 of 112x112 (the card's 256 of
    224x224 cut for the CPU): every loss of 25 steps, the means of the
    first and last 5;
  - ``fp32_vs_float64``: ``gluon_fp32_card_vs_cpu``'s step (batch 2,
    224x224, the same seeded weights) on the CPU in fp32 against
    float64, hybridized and imperatively: the budget's numbers;
  - ``attention_fp32_vs_float64``: ``gluon_attention``'s fp32 step
    (batch 2, the block's seeded weights) in fp32 against float64: each
    parameter's update, relative to its own largest element and to the
    block's largest update;
  - ``small_resnets``: ``tests/test_torch_gluon_resnet.py``'s steps
    (resnet18_v1, resnet50_v1, resnet50_v2, batch 2 of 64x64), each
    package's f32 against the port's float64: the training logits and
    the update, relative to their largest value, with oneDNN's
    convolutions on and off.

* ``decode_vs_lm``, ``beam``, ``vit``, ``zoo``: the decode, beam, ViT and
  zoo phases of ``chip_smoke.py``, with its own helpers, on the CPU at
  full width and cut depth or batch:

  - ``decode_vs_lm``: GPT-2 small's widths at 2 layers (not 12): the
    LM's teacher-forced log-probabilities at seq 1024 against the decode
    step's over the first 64 positions;
  - ``beam``: the same model, 4 prompts x beam 4, 32 tokens: each beam's
    score against its re-scoring by the teacher-forced LM;
  - ``vit``: ViT-S/16 at full depth and width, 224x224, batch 16 (the
    card's 128 cut for the CPU), the phase's two batches and Adam lr
    5e-4: every loss of 25 steps in fp32 and 12 in bf16;
  - ``zoo``: every zoo network of the phase with its seeded weights and
    images: the logits of ``Module.predict`` in f32, with the CPU's
    oneDNN convolutions and with PyTorch's plain ones (two reduction
    orders; the card's cuDNN is a third), each against the interpreter's
    float64 run, relative to the logits' spread (largest minus
    smallest).  The float64 run's flash attention (ViT) is the plain
    version, which computes in f32.

* ``rnn`` (about a minute on 8 cores): the numbers behind the RNN
  phases' margins and budgets, at full width on the CPU in fp32:

  - ``rnn_train``: the phase's loop (rnn_bench.py's model, lr and
    momentum, 5 + 20 steps over two batches of its rule, drawn by the
    CPU's generator: the card draws with a CUDA one): every loss, the
    means of the first and last 5;
  - ``rnn_fp32_vs_float64`` and ``gluon_lstm_fp32_vs_float64_*``: the
    fp32 checks' steps against float64 (the executor in float64; the
    Gluon net cast to float64): the loss and each parameter's update
    relative to its own largest element;
  - ``ptb_bucketing``: the phase's epoch (every batch's bucket and mean
    NLL, the first and last 10's means);
  - ``gluon_lstm_*``: the Gluon LM's 15 steps on the same batches.

* ``ssd`` (several minutes): the numbers behind the SSD phases' margin
  and budgets (``part_ssd``): the ``ssd_train`` loop at batch 4 in fp32,
  the fp32 step against float64, the analytic multiply-adds and the
  detect graph's NMS.

* ``zoo_data`` (about ten minutes on 8 cores): the numbers behind the
  gluon.data / zoo and loss-head phases, with ``chip_smoke.py``'s own
  helpers on the CPU:

  - ``train_<net>``: ``gluon_zoo_train``'s loop (the DataLoader with
    its worker threads, 3 + 10 steps, SGD lr 0.005) in fp32 at batch 16
    (the card's 64 cut for the CPU), VGG-16, AlexNet, SqueezeNet 1.1 and
    MobileNet at 112x112, DenseNet-121 at 224x224, Inception v3 at
    299x299: every loss and the drop of the last 3's mean from the first
    3's;
  - ``fp32_vs_float64_<net>``: ``gluon_zoo_fp32_card_vs_cpu``'s step
    (batch 2 at full size, the same seeded weights) in fp32 against
    float64: the budget's numbers;
  - ``heads_<example>``: ``module_heads``' runs (the metric before and
    after the epochs) and one step with one CPU thread against all of
    them (two fp32 reduction orders, as the card and the CPU are).

* ``c1b2`` (a few minutes on 8 cores): the numbers behind the MoE LM
  and ops_c1b2 phases (``part_c1b2``): the moe_lm_train loop at 2
  layers and batch 1 in fp32, the MoE fp32 step against float64, the
  MoE decode step against the LM, the linalg and CTC cases in fp32
  against float64, and the custom_softmax example's accuracy.

* ``c8`` (several minutes on 8 cores): the numbers behind the
  ``resnet_lars_fit``, ``resnet_finetune`` and ``front_end`` phases
  (``part_c8``), with ``chip_smoke.py``'s own helpers on the CPU:

  - ``lars_fit``: the phase's ``Module.fit`` (LARS, bf16 compute,
    PrefetchingIter over ResizeIter, 16 batches) at the card's batch 256
    of 112x112 images (224x224 cut for the CPU): every loss and the first
    4's mean minus the last 4's;
  - ``lars_eval``: the reshape checks at batch 256 -> 64 (the batch-64
    eval against the batch-256 rows, relative to the largest
    probability, and the same distance to the next images' rows, the
    control), and the bf16 eval against an fp32 Module's on the same
    parameters: the spread bf16 itself gives;
  - ``finetune``: the fine-tune stage from that checkpoint (frozen trunk,
    SGD lr 0.01 on a 100-class head): every loss and the drop;
  - ``optimizer_budgets``: every optimizer's FE_STEPS updates of
    ResNet-50's parameter shapes on the CPU in fp32 against float64
    (and with bf16 weights under multi_precision, the fp32 masters
    against float64 from the bf16-rounded inputs): the worst array's
    ||a - b|| / ||b - w0||.

* ``moe_bf16`` (seconds): the JAX package's bf16 MoE routing fault at
  GPT-2 small's token count (``part_moe_bf16``), beside the port's
  routing of the same logits.

* ``c2`` (about ten seconds): the numbers behind ``chip_smoke.py``'s
  ``sparse_linear`` and ``two_tower_fit`` phases (``part_c2``), with
  their own data and loops on the CPU at the card's sizes: each loss
  curve (the phases require it to fall), the CPU's seconds a step, and
  the float32 run's distance from a float64 run of the same steps, on
  which ``SPARSE_TOL`` and ``TOWER_TOL`` rest.

* ``c3`` (about ten seconds): the numbers behind the record phases of
  ``chip_smoke.py`` (``part_c3``), with its own image generator
  (``rec_image``) on the CPU:

  - ``record_kb``: the mean, least and largest JPEG size of PIL's
    quality-95 encoder (4:2:0) over the generator's noise range at
    ImageNet's 500 x 375, the choice of ``REC_NOISE`` against
    ``REC_KB_RANGE``;
  - ``libjpeg_vs_pil``: the host library's decode (``native/jpeg_io.cc``)
    against PIL's on those JPEGs, mean absolute levels, beside
    ``DECODE_MAD_TOL``;
  - ``dct_downscale``: at each decode size, the host path's pixels (the
    fused pass, which decodes at 1/d in the DCT domain where the image is
    at least twice the size, ``jpeg_io.cc decode_one``) against the card
    path's arithmetic (the full-size decode resized by I1's plain
    version), both from libjpeg's decode: mean and largest absolute
    levels, with d; nvJPEG's own distance from libjpeg comes on top
    (``rec_write``'s ``mad_vs_pil``).

* ``e1`` (a few minutes): the numbers behind ``chip_smoke.py``'s
  ``dist_async_lm_fit`` (``part_e1``): the LM at full width, 2 layers,
  batch 8, fp32 on the CPU, over dist_async with two in-process servers
  and 2-bit pushes at the phase's threshold: each step's loss, the share
  of values that fired, and the first gradient's quantiles.

* ``e1_sync`` (two or three minutes): why ``dist_sync_fit`` holds the
  update in norm (``part_e1_sync``): its 4 Adam steps on the CPU, on the
  whole batches and on the sums of their halves' gradients (the
  all-reduce): the first gradients' distance, the share of values whose
  sign flips, and the two updates' distance after each step.

It imports both packages, as the tests do.
"""
import json
import os
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.executor import build_interpreter as jbuild  # noqa: E402
from mxnet_tpu.models.resnet import resnet as j_resnet  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.executor import build_interpreter as tbuild  # noqa
from mxnet_tpu_torch.models.resnet import resnet as t_resnet  # noqa: E402

import chip_smoke as cs  # noqa: E402

INPUTS = ("data", "softmax_label")
ULP = np.float32(1 + 2 ** -23)
BATCH = 50
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def digits_batches(steps):
    """``tests/test_convergence.py``'s batches."""
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    x = x.repeat(3, axis=1).repeat(3, axis=2)
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))
    x = np.stack([x, x, x], axis=1)
    order = np.random.RandomState(0).permutation(len(x))
    x, y = x[order], y[order]
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(steps)]


def nll(prob, y):
    return float(-np.mean(np.log(np.maximum(
        prob[np.arange(len(y)), y.astype(int)], 1e-8))))


def jax_curve(batches, nudge):
    net = jmodels.resnet(num_classes=10, num_layers=20,
                         image_shape=(3, 28, 28))
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, 28, 28))],
             label_shapes=[("softmax_label", (BATCH,))])
    mx.random.seed(7)
    np.random.seed(7)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    args, aux = mod.get_params()
    init = ({n: v.asnumpy().copy() for n, v in args.items()},
            {n: v.asnumpy().copy() for n, v in aux.items()})
    if nudge:
        mod.set_params({n: mx.nd.array(v.asnumpy() * ULP)
                        for n, v in args.items()}, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    losses = []
    for x, y in batches:
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                    is_train=True)
        losses.append(nll(mod.get_outputs()[0].asnumpy(), y))
        mod.backward()
        mod.update()
    return np.array(losses), init


def port_curve(batches, args, aux):
    net = mt.models.resnet(num_classes=10, num_layers=20,
                           image_shape=(3, 28, 28))
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, 28, 28))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    losses = []
    for x, y in batches:
        mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                    [mt.nd.array(y, ctx=mt.cpu())]),
                    is_train=True)
        losses.append(nll(mod.get_outputs()[0].asnumpy(), y))
        mod.backward()
        mod.update()
    return np.array(losses)


def jax_step(net, args, aux, x, y):
    run, names, aux_names = jbuild(net)
    pnames = [n for n in names if n not in INPUTS]

    def f(*pv):
        env = dict(zip(pnames, pv), data=jnp.asarray(x),
                   softmax_label=jnp.asarray(y))
        return run([env[n] for n in names],
                   [jnp.asarray(aux[n]) for n in aux_names],
                   jax.random.PRNGKey(0), True)[0][0]

    def step(pv):
        out, vjp = jax.vjp(f, *pv)
        return out, vjp(jnp.ones_like(out))
    out, grads = jax.jit(step)(tuple(jnp.asarray(args[n]) for n in pnames))
    return np.asarray(out, np.float64), {
        n: np.asarray(g, np.float64) for n, g in zip(pnames, grads)}


def port_step(net, args, aux, x, y, dtype):
    run, names, aux_names = tbuild(net)
    vals = [torch.from_numpy(x if n == "data" else y if n == "softmax_label"
                             else args[n]).to(dtype) for n in names]
    pnames = [n for n in names if n not in INPUTS]
    leaves = [v.requires_grad_() for n, v in zip(names, vals)
              if n in pnames]
    outs, _ = run(vals, [torch.from_numpy(aux[n]).to(dtype)
                         for n in aux_names], is_train=True)
    grads = torch.autograd.grad(outs[0], leaves, torch.ones_like(outs[0]),
                                allow_unused=True)
    return outs[0].detach().double().numpy(), {
        n: g.double().numpy() for n, g in zip(pnames, grads)
        if g is not None}


def against(truth_out, truth_grads, out, grads):
    scale = max(np.abs(g).max() for g in truth_grads.values())
    return {"forward": float(np.abs(out - truth_out).max()
                             / np.abs(truth_out).max()),
            "gradient": float(max(np.abs(grads[n] - truth_grads[n]).max()
                                  for n in truth_grads) / scale)}


def compare(jnet, tnet, args, aux, x, y):
    o64, g64 = port_step(tnet, args, aux, x, y, torch.float64)
    o32, g32 = port_step(tnet, args, aux, x, y, torch.float32)
    jo, jg = jax_step(jnet, args, aux, x, y)
    return {"jax_f32": against(o64, g64, jo, jg),
            "port_f32": against(o64, g64, o32, g32)}


def small_params(net, B, shape, seed=0):
    arg_shapes, _, aux_shapes = net.infer_shape(data=(B,) + shape,
                                                softmax_label=(B,))
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                if n.endswith("_weight") else rng.uniform(0.5, 1.5, s)
                if n.endswith("_gamma") else rng.randn(*s) * 0.1)
            .astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in INPUTS}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def part_resnet():
    batches = digits_batches(24)
    with open(os.path.join(ROOT, "tests", "golden",
                           "resnet20_loss_curve.json")) as f:
        golden = np.array(json.load(f)["losses"])
    jplain, (args, aux) = jax_curve(batches, nudge=False)
    jnudged, _ = jax_curve(batches, nudge=True)
    tplain = port_curve(batches, args, aux)
    tnudged = port_curve(batches, {n: v * ULP for n, v in args.items()},
                         aux)
    print(json.dumps({"golden_curve": {
        name: float(np.abs(c - golden).max()) for name, c in (
            ("jax", jplain), ("jax_one_ulp", jnudged), ("port", tplain),
            ("port_one_ulp", tnudged))}}))

    jnet = jmodels.resnet(num_classes=10, num_layers=20,
                          image_shape=(3, 28, 28))
    x, y = batches[0]
    print(json.dumps({"digits_gradients": compare(
        jnet, mt.models.resnet(num_classes=10, num_layers=20,
                               image_shape=(3, 28, 28)), args, aux, x, y)}))

    kw = dict(units=[1, 1, 1], num_stages=3, filter_list=[8, 8, 16, 32],
              num_classes=10, image_shape=(3, 28, 28), bottle_neck=False)
    sargs, saux = small_params(j_resnet(**kw), 8, (3, 28, 28))
    rng = np.random.RandomState(1)
    sx = rng.uniform(-1, 1, (8, 3, 28, 28)).astype(np.float32)
    sy = rng.randint(0, 10, (8,)).astype(np.float32)
    print(json.dumps({"small_batch8_gradients": compare(
        j_resnet(**kw), t_resnet(**kw), sargs, saux, sx, sy)}))

    B, shape = cs.RESNET_FP32_BATCH, cs.RESNET_FP32_IMAGE
    sym, rargs, raux = cs.resnet_numpy_params(
        mt, B, shape, cs.SEED + 7)
    rng = np.random.default_rng(cs.SEED + 8)
    rx = rng.uniform(-1, 1, (B,) + shape).astype(np.float32)
    ry = rng.integers(0, 1000, B).astype(np.float32)
    _, g64 = port_step(sym, rargs, raux, rx, ry, torch.float64)
    _, g32 = port_step(sym, rargs, raux, rx, ry, torch.float32)
    per = {n: float(np.abs(g32[n] - g64[n]).max() / np.abs(g64[n]).max())
           for n in g64}
    worst = max(per, key=per.get)
    norm = float(np.sqrt(sum(((g32[n] - g64[n]) ** 2).sum() for n in g64)
                         / sum((g ** 2).sum() for g in g64.values())))
    print(json.dumps({"resnet50_fp32_vs_float64": {
        "gradient_norm_rel": norm, "worst_param": worst,
        "worst_param_rel": per[worst]}}))



REHEARSAL_LAYERS = 2


def _gpt2():
    """The phase's config at REHEARSAL_LAYERS layers, and its weights."""
    cs.GPT2_SMALL = dict(cs.GPT2_SMALL, num_layers=REHEARSAL_LAYERS)
    net = mt.models.transformer_lm(**cs.GPT2_SMALL)
    return cs.gpt2_params(net, cs.SEED)


def part_decode_vs_lm():
    params = _gpt2()
    S, V = cs.GPT2_SMALL["seq_len"], cs.GPT2_SMALL["vocab_size"]
    toks = np.random.default_rng(cs.SEED + 11).integers(0, V, (1, S),
                                                        dtype=np.int32)
    ref = cs.lm_logprobs(mt, params, toks, mt.cpu())[0]
    mod = cs.decode_module(mt, params, 1, mt.cpu())
    worst = 0.0
    for t in range(cs.DECODE_STEPS):
        tok = mt.nd.array(toks[:, t].astype(np.float32), ctx=mt.cpu())
        logits = cs.decode_step(mt, mod, tok).asnumpy()[0]
        worst = max(worst, float(np.abs(cs.log_softmax_np(logits)
                                        - ref[t]).max()))
    return dict(layers=REHEARSAL_LAYERS, positions=cs.DECODE_STEPS,
                max_abs_logp_diff=worst,
                logp_range=[float(ref[:cs.DECODE_STEPS].min()),
                            float(ref[:cs.DECODE_STEPS].max())])


def part_beam():
    params = _gpt2()
    prompts = np.array(cs.BEAM_PROMPTS)
    P, K, G = len(prompts), cs.BEAM_SIZE, cs.BEAM_GEN
    mod = cs.decode_module(mt, params, P * K, mt.cpu())
    seqs, scores = mt.models.beam_search(mod, prompts, beam_size=K,
                                         gen_len=G)
    flat = seqs.reshape(P * K, G + 1)
    lp = cs.lm_logprobs(mt, params, flat.astype(np.int32), mt.cpu())
    rescored = np.array([lp[i, np.arange(G), flat[i, 1:]].sum()
                         for i in range(P * K)]).reshape(P, K) / G
    return dict(layers=REHEARSAL_LAYERS, beams=K, gen_len=G,
                max_abs_score_diff=float(np.abs(rescored - scores).max()),
                scores=scores.tolist())


def vit_losses(dtype, steps, batch):
    mod = mt.mod.Module(mt.models.vit(1000), context=mt.cpu(),
                        compute_dtype=dtype)
    mod.bind(data_shapes=[("data", (batch, 3, 224, 224))],
             label_shapes=[("softmax_label", (batch,))])
    mt.random.seed(cs.SEED)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": cs.VIT_LR})
    batches = cs.resnet_batches(torch, mt, torch.device("cpu"), batch,
                                (3, 224, 224), cs.SEED + 12)
    return cs.resnet_steps(mt, mod, batches, steps, lambda: None)[1]


def part_vit():
    out = {}
    for dtype, steps in ((None, 25), ("bfloat16", 12)):
        t0 = time.monotonic()
        losses = vit_losses(dtype, steps, 16)
        out[dtype or "float32"] = dict(
            steps=steps, losses=losses,
            first5=float(np.mean(losses[:5])),
            last5=float(np.mean(losses[-5:])),
            seconds=time.monotonic() - t0)
    return dict(batch=16, **out)



def part_deep_bn():
    """A deep BatchNorm network's training gradient (batch statistics)
    in f32, both packages, against the port in float64: mobilenet at
    multiplier 0.25, three seeds of weights and images at each size."""
    kw = dict(num_classes=10, multiplier=0.25)
    rows = []
    for shape in ((8, 3, 64, 64), (12, 3, 64, 64), (8, 3, 96, 96)):
        for seed in range(3):
            net = mt.models.get_symbol("mobilenet", **kw)
            args, aux = small_params(net, shape[0], shape[1:], seed)
            rng = np.random.RandomState(seed + 1)
            x = rng.uniform(-1, 1, shape).astype(np.float32)
            y = rng.randint(0, 10, shape[0]).astype(np.float32)
            with torch.backends.mkldnn.flags(enabled=False):
                res = compare(jmodels.get_symbol("mobilenet", **kw), net,
                              args, aux, x, y)
            rows.append(dict(shape=list(shape), seed=seed, **res))
    return dict(network="mobilenet x0.25", rows=rows)


def logits64(net, args, aux, x):
    """``net``'s logits by the interpreter in float64 (inference)."""
    run, names, aux_names = tbuild(cs.logits_graph(mt, net))
    vals = [torch.from_numpy(x if n == "data" else args[n]).double()
            for n in names]
    outs, _ = run(vals, [torch.from_numpy(aux[n]).double()
                         for n in aux_names], generator=torch.Generator())
    return outs[0].numpy()


def part_zoo():
    out = {}
    for i in range(len(cs.ZOO)):
        name, _, net, args, aux, x = cs.zoo_case(mt, i)
        exact = logits64(net, args, aux, x)
        spread = float(exact.max() - exact.min())
        row = dict(logit_spread=spread)
        for onednn in (True, False):
            with torch.backends.mkldnn.flags(enabled=onednn):
                got = cs.zoo_predict(mt, cs.logits_graph(mt, net), args,
                                     aux, x, mt.cpu())
            row["onednn" if onednn else "plain"] = float(
                np.abs(got - exact).max()) / spread
        out[name] = row
    return dict(networks=out,
                worst=max(max(r["onednn"], r["plain"])
                          for r in out.values()))


def part_gluon():
    ctx = mt.cpu()
    out = {}
    # the training loop's losses (the margin of gluon_resnet_train)
    B, shape = 16, (3, 112, 112)
    net = cs.gluon_resnet(mt, ctx, cs.SEED, hybridize=False)
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(cs.GLUON_OPT))
    batches = cs.gluon_batches(torch, mt, torch.device("cpu"), B, shape,
                               cs.SEED + 20)
    n = cs.GLUON_WARMUP + cs.GLUON_STEPS
    _, losses = cs.gluon_train_steps(
        mt, net, trainer, mt.gluon.loss.SoftmaxCrossEntropyLoss(), batches,
        n, lambda: None)
    out["train"] = dict(batch=B, image=list(shape), losses=losses,
                        first5=float(np.mean(losses[:5])),
                        last5=float(np.mean(losses[-5:])))
    # the fp32 card-vs-CPU budget: the CPU's fp32 against float64
    values = cs.gluon_numpy_params(mt, cs.SEED + 21)
    rng = np.random.default_rng(cs.SEED + 22)
    x = rng.uniform(-1, 1, (cs.GLUON_FP32_BATCH,) + cs.GLUON_FP32_IMAGE) \
        .astype(np.float32)
    y = rng.integers(0, 1000, cs.GLUON_FP32_BATCH).astype(np.int32)
    for hybridize in (True, False):
        row = cs.gluon_fp32_compare(
            cs.gluon_fp32_step(mt, ctx, values, x, y, hybridize),
            cs.gluon_fp32_step(mt, ctx, values, x.astype(np.float64), y,
                               hybridize, dtype="float64"), values)
        out["fp32_vs_float64_" + ("hybridized" if hybridize
                                  else "imperative")] = row
    # the attention block's fp32 step against float64 (the basis of
    # gluon_attention's fp32 check): each parameter's update, relative to
    # its own largest element and to the block's largest update
    rng = np.random.default_rng(cs.SEED + 30)
    avals = cs.attention_values(mt, cs.SEED + 31)
    full = (cs.ATTN_BATCH, cs.ATTN_SEQ, cs.ATTN_D)    # as the phase draws
    ax = rng.standard_normal(full).astype(np.float32)[:cs.ATTN_FP32_BATCH]
    at = rng.standard_normal(full).astype(np.float32)[:cs.ATTN_FP32_BATCH]

    def attn_update(dtype):
        net = cs.attention_block(mt)
        net.initialize(ctx=ctx)
        net.cast(dtype)
        mt.convert.gluon_params_from_numpy(net.collect_params(), avals)
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        with mt.autograd.record():
            loss = mt.gluon.loss.L2Loss()(
                net(mt.nd.array(ax, ctx=ctx, dtype=dtype)),
                mt.nd.array(at, ctx=ctx, dtype=dtype))
        loss.backward()
        tr.step(cs.ATTN_FP32_BATCH)
        return {k: v.astype(np.float64) - avals[k] for k, v in
                mt.convert.gluon_params_to_numpy(net.collect_params())
                .items()}
    u32, u64 = attn_update("float32"), attn_update("float64")
    scale = max(float(np.abs(v).max()) for v in u64.values())
    out["attention_fp32_vs_float64"] = {
        k: dict(own=float(np.abs(u32[k] - u64[k]).max()
                          / np.abs(u64[k]).max()),
                block=float(np.abs(u32[k] - u64[k]).max()) / scale)
        for k in u64}
    # the small ResNets of tests/test_torch_gluon_resnet.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_gluon_resnet as tg
    small = {}
    with ctx:
        for name in tg.NETS:
            for onednn in (True, False):
                tg._CACHE.clear()
                with torch.backends.mkldnn.flags(enabled=onednn):
                    before, xs, ys, f64, t32 = tg._reference(name)
                    jnet, _ = tg._build(name)
                    j32 = tg._step(mx, jnet, xs, ys)

                def logit_err(r):
                    return float(np.abs(r[0] - f64[0]).max()
                                 / np.abs(f64[0]).max())
                small[f"{name}_onednn_{'on' if onednn else 'off'}"] = dict(
                    port_logits=logit_err(t32), jax_logits=logit_err(j32),
                    port_update=tg._update_err(t32[2], f64[2], before),
                    jax_update=tg._update_err(j32[2], f64[2], before))
    out["small_resnets"] = small
    return out


def _rnn_float64_step(params, x, y):
    """rnn_fp32_step's step in float64 through the executor: the loss
    and each parameter's update (SGD's first momentum step: -lr x the
    gradient / batch)."""
    sym = cs.rnn_lm_sym(mt)
    args = {n: mt.nd.NDArray(torch.from_numpy(v.astype(np.float64)))
            for n, v in params.items()}
    args["data"] = mt.nd.NDArray(torch.from_numpy(x))
    args["softmax_label"] = mt.nd.NDArray(torch.from_numpy(y))
    req = {n: ("write" if n in params else "null") for n in args}
    ex = mt.executor.Executor(sym, mt.cpu(), args=args, grad_req=req)
    out = ex.forward(is_train=True)[0]
    ex.backward()
    lr, B = cs.RNN_OPT["learning_rate"], x.shape[0]
    upd = {n: -lr * ex.grad_dict[n].asnumpy() / B for n in params}
    p = out.asnumpy()[np.arange(y.size), y.reshape(-1)]
    return float(-np.log(p + 1e-12).mean()), upd


def part_rnn():
    """The numbers behind chip_smoke.py's RNN phases, fixed before their
    first card run: the rnn_train loop's losses (fp32, the CPU's own
    seeded batches: the card draws its two batches with a CUDA
    generator), the fp32 step's distance from float64 (rnn_fp32 and
    gluon_lstm_fp32), the PTB bucketing epoch's per-batch NLL and the
    Gluon LM's losses."""
    ctx, cpu = mt.cpu(), torch.device("cpu")
    out = {}
    mod = cs.rnn_module(mt, ctx)
    batches = cs.rnn_batches(torch, mt, cpu, cs.RNN["batch"], cs.SEED + 41)
    t0 = time.monotonic()
    _, losses = cs.resnet_steps(mt, mod, batches,
                                cs.RNN_WARMUP + cs.RNN_STEPS, lambda: None)
    out["rnn_train"] = dict(losses=losses, seconds=time.monotonic() - t0,
                            first5=float(np.mean(losses[:5])),
                            last5=float(np.mean(losses[-5:])))
    del mod
    params = cs.rnn_numpy_params(mt, cs.SEED + 42)
    x, y = cs.rnn_numpy_batch(cs.SEED + 43, cs.RNN["batch"])
    l32, u32 = cs.rnn_fp32_step(mt, ctx, params, x, y)
    l64, u64 = _rnn_float64_step(params, x, y)
    rel = cs.update_rel_diffs(u32, u64)
    out["rnn_fp32_vs_float64"] = dict(loss32=l32, loss64=l64,
                                      loss_diff=abs(l32 - l64),
                                      update_rel_diff=rel,
                                      worst=max(rel.values()))
    gvals = mt.convert.gluon_params_to_numpy(
        cs.gluon_lm(mt, ctx).collect_params())
    gx, gy = cs.rnn_numpy_batch(cs.SEED + 44, cs.GLUON_LM_FP32_BATCH)
    for hyb in (True, False):
        g32 = cs.gluon_lm_fp32_step(mt, ctx, gvals, gx, gy, hyb)
        g64 = cs.gluon_lm_fp32_step(mt, ctx, gvals, gx, gy, hyb,
                                    dtype="float64")
        rel = cs.update_rel_diffs(g32[1], g64[1])
        out["gluon_lstm_fp32_vs_float64_" + ("hybridized" if hyb
                                             else "imperative")] = dict(
            loss_diff=abs(g32[0] - g64[0]), update_rel_diff=rel,
            worst=max(rel.values()))
    t0 = time.monotonic()
    _, rows, _ = cs.ptb_fit(mt, ctx, cs.PTB, None, lambda: None)
    nll = [r["nll"] for r in rows]
    w = cs.PTB_WINDOW
    out["ptb_bucketing"] = dict(batches=len(rows),
                                buckets=[r["bucket"] for r in rows],
                                nll=nll, first=float(np.mean(nll[:w])),
                                last=float(np.mean(nll[-w:])),
                                seconds=time.monotonic() - t0)
    for hyb in (True, False):
        net = cs.gluon_lm(mt, ctx)
        if hyb:
            net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(cs.GLUON_LM_OPT))
        pairs = [(b.data[0], b.label[0]) for b in batches]
        _, gl = cs.gluon_train_steps(
            mt, net, trainer, cs.gluon_lm_loss(mt), pairs,
            cs.GLUON_LM_WARMUP + cs.GLUON_LM_STEPS, lambda: None)
        gl = [v / cs.RNN["seq"] for v in gl]
        out["gluon_lstm_" + ("hybridized" if hyb else "imperative")] = \
            dict(losses=gl, drop3=float(np.mean(gl[:3]) - np.mean(gl[-3:])))
    return out


SSD_REHEARSAL_BATCH = 4


def _ssd_float64_step(params, x, y):
    """ssd_fp32_step's step in float64 through the executor: the loss
    (ssd_stats' cls + loc) and each parameter's update (SGD's first
    momentum step: -lr x (clip(rescale_grad x gradient) + wd x weight)),
    and MultiBoxTarget's class targets."""
    sym = mt.models.ssd_vgg16(num_classes=cs.SSD["num_classes"])
    args = {n: mt.nd.NDArray(torch.from_numpy(v.astype(np.float64)))
            for n, v in params.items()}
    args["data"] = mt.nd.NDArray(torch.from_numpy(x.astype(np.float64)))
    args["label"] = mt.nd.NDArray(torch.from_numpy(y.astype(np.float64)))
    req = {n: ("write" if n in params else "null") for n in args}
    ex = mt.executor.Executor(sym, mt.cpu(), args=args, grad_req=req)
    outs = ex.forward(is_train=True)
    ex.backward()
    loss = float(cs.ssd_stats(torch, outs)[:2].sum())
    o = cs.SSD_OPT
    upd = {}
    for n, w in params.items():
        g = ex.grad_dict[n].asnumpy() * o["rescale_grad"]
        g = np.clip(g, -o["clip_gradient"], o["clip_gradient"])
        upd[n] = -o["learning_rate"] * (g + o["wd"] * w.astype(np.float64))
    return loss, upd, outs[2].asnumpy()


def part_ssd():
    """The numbers behind chip_smoke.py's SSD phases, fixed before their
    first card run: the ssd_train loop on the CPU in fp32 at batch
    SSD_REHEARSAL_BATCH (the card's 32 cut for the CPU; 300x300, 20
    classes, the phase's optimizer and batch rule drawn by the CPU's
    generator), every step's cls and loc losses and anchors; the
    ssd_fp32 step's distance from float64 (loss, each parameter's update
    relative to its largest element, class targets that differ); the
    analytic multiply-adds; and the detect graph's NMS at batch 2 with
    the rehearsal's trained weights (valid and kept boxes, fixed-point
    rounds)."""
    from mxnet_tpu_torch.ops import detection
    ctx, cpu = mt.cpu(), torch.device("cpu")
    B = SSD_REHEARSAL_BATCH
    out = {"forward_macs_per_image": cs.conv_macs(
        mt, mt.models.ssd_vgg16(cs.SSD["num_classes"]),
        dict(data=(1, 3, 300, 300), label=(1, cs.SSD["max_objects"], 5)))}
    mod = cs.ssd_module(mt, ctx, batch=B)
    batches = cs.ssd_batches(torch, mt, cpu, B, cs.SEED + 60)
    t0 = time.monotonic()
    _, stats = cs.ssd_steps(torch, mt, mod, batches,
                            cs.SSD_WARMUP + cs.SSD_STEPS, lambda: None)
    losses = (stats[:, 0] + stats[:, 1]).tolist()
    out["ssd_train"] = dict(
        batch=B, seconds=time.monotonic() - t0, losses=losses,
        cls=stats[:, 0].tolist(), loc=stats[:, 1].tolist(),
        positive=stats[:, 2].tolist(), negative=stats[:, 3].tolist(),
        first5=float(np.mean(losses[:5])), last5=float(np.mean(losses[-5:])),
        drop=float(np.mean(losses[:5]) - np.mean(losses[-5:])))
    trained = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    del mod
    params = cs.ssd_numpy_params(mt, cs.SEED + 61, cs.SSD_FP32_BATCH)
    b = cs.ssd_batches(torch, mt, cpu, cs.SSD_FP32_BATCH, cs.SEED + 62,
                       n=1)[0]
    x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
    l32, u32, _, outs32, _ = cs.ssd_fp32_step(torch, mt, ctx, params, x, y)
    l64, u64, ct64 = _ssd_float64_step(params, x, y)
    rel = cs.update_rel_diffs(u32, u64)
    out["ssd_fp32_vs_float64"] = dict(
        loss32=l32, loss64=l64, loss_diff=abs(l32 - l64),
        worst=max(rel.values()), worst_param=max(rel, key=rel.get),
        cls_target_differences=int((outs32[2] != ct64).sum()),
        positives=int((outs32[2] > 0).sum()))
    net = mt.models.ssd_vgg16(cs.SSD["num_classes"], mode="detect")
    dmod = mt.mod.Module(net, context=ctx, label_names=None)
    dmod.bind([mt.io.DataDesc("data", (2, 3, 300, 300))], for_training=False)
    dmod.init_params(arg_params={n: mt.nd.array(v, ctx=ctx)
                                 for n, v in trained.items()
                                 if n in net.list_arguments()})
    stats = {}
    orig = detection.nms_keep

    def counted(*a, **kw):
        return orig(*a, **dict(kw, stats=stats))
    detection.nms_keep = counted
    try:
        det = dmod.predict(mt.io.NDArrayIter(
            batches[0].data[0].asnumpy()[:2], batch_size=2)).asnumpy()
    finally:
        detection.nms_keep = orig
    out["ssd_detect_nms"] = dict(
        kept=(det[..., 0] >= 0).sum(1).tolist(),
        valid=(det[..., 1] >= 0.01).sum(1).tolist(), **stats)
    return out


def part_zoo_data():
    """The numbers behind chip_smoke.py's gluon_zoo_train margin,
    gluon_zoo_fp32 budget and module_heads margins and step tolerance,
    with its own helpers, on the CPU before the first card run."""
    ctx = mt.cpu()
    out = {}
    n = cs.ZOO_WARMUP + cs.ZOO_STEPS
    B = 16
    sides = {"densenet121": 224, "inceptionv3": 299}
    for name, side in cs.ZOO_NETS:
        side = sides.get(name, 112)
        images, labels = cs.zoo_images(side, cs.SEED + 40)
        net = cs.zoo_net(mt, name, ctx, cs.SEED)
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(cs.ZOO_OPT))
        with ctx:
            loader = cs.zoo_loader(mt, images, labels, B, cs.ZOO_WORKERS,
                                   cs.SEED + 41)
            wait, step, losses, _ = cs.zoo_train_loop(
                mt, net, trainer, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                loader, n, lambda: None)
        out[f"train_{name}"] = dict(
            batch=B, side=side, losses=losses,
            drop=float(np.mean(losses[:3]) - np.mean(losses[-3:])),
            median_step_ms=float(np.median(step)),
            median_wait_ms=float(np.median(wait)))
        print(json.dumps({name: out[f"train_{name}"]}), flush=True)
    for i, (name, side) in enumerate(cs.ZOO_NETS):
        values = cs.zoo_numpy_params(mt, name, side, cs.SEED + 50 + i)
        rng = np.random.default_rng(cs.SEED + 60 + i)
        x = rng.uniform(-1, 1, (cs.ZOO_FP32_BATCH, 3, side, side)) \
            .astype(np.float32)
        y = rng.integers(0, 1000, cs.ZOO_FP32_BATCH).astype(np.int32)
        row = cs.zoo_fp32_compare(
            cs.zoo_fp32_step(mt, ctx, name, values, x, y),
            cs.zoo_fp32_step(mt, ctx, name, values, x.astype(np.float64),
                             y, dtype="float64"), values)
        out[f"fp32_vs_float64_{name}"] = row
        print(json.dumps({name: row}), flush=True)
    threads = torch.get_num_threads()
    for name, (metric, sense, run) in cs.HEADS.items():
        before, after, _ = run(mt, ctx, cs.HEADS_EPOCHS[name])
        init = cs.heads_params(mt, name, ctx)
        many = cs.heads_params(mt, name, ctx, init, steps=1)
        torch.set_num_threads(1)
        try:
            one = cs.heads_params(mt, name, ctx, init, steps=1)
        finally:
            torch.set_num_threads(threads)
        out[f"heads_{name}"] = dict(
            metric=metric, before=before, after=after,
            gain=(before - after) if sense == "min" else (after - before),
            step_one_vs_many_threads=cs.heads_step_diff(one, many))
        print(json.dumps({name: out[f"heads_{name}"]}), flush=True)
    return out


def _moe_float64_step(params, x, y):
    """moe_fp32_step's step in float64 through the executor: the loss,
    the new parameters (SGD at batch 1: -lr x the gradient) and the
    experts each token was routed to."""
    from mxnet_tpu_torch.ops import moe
    cfg = dict(cs.MOE, num_layers=cs.MOE_FP32_LAYERS)
    sym = mt.models.transformer_lm(**cfg)
    args = {n: mt.nd.NDArray(torch.from_numpy(v.astype(np.float64)))
            for n, v in params.items()}
    args["data"] = mt.nd.NDArray(torch.from_numpy(x))
    args["softmax_label"] = mt.nd.NDArray(torch.from_numpy(y))
    req = {n: ("write" if n in params else "null") for n in args}
    ex = mt.executor.Executor(sym, mt.cpu(), args=args, grad_req=req)
    with moe.collect_routing() as st:
        loss = float(ex.forward(is_train=True)[0].asnumpy())
        ex.backward()
    new = {n: params[n] - cs.MOE_FP32_LR * ex.grad_dict[n].asnumpy()
           for n in params}
    return loss, new, [e.numpy() for e in st["experts"]], 0.0


def part_c1b2():
    """The numbers behind chip_smoke.py's moe_lm_train margin, the
    moe_fp32 and decode-vs-LM budgets and the ops_c1b2 budgets and
    margin, with its own helpers, on the CPU before the first card run:

    - ``moe_train``: the phase's loop (Adam lr 3e-4, Xavier gaussian
      magnitude 2, MOE_WARMUP + MOE_STEPS steps on lm_batch's rule) in
      fp32 at 2 layers and batch 1 (the card's 12 layers and batch 8 cut
      for the CPU): every loss and the drop;
    - ``moe_fp32_vs_float64``: moe_fp32_card_vs_cpu's step (2 layers,
      batch 1, the same seeded weights) in fp32 against float64;
    - ``moe_decode_vs_lm``: the phase's decode step against the
      teacher-forced LM (batch 32, 16 positions, 12 layers, GPT-2's
      initialisation): drops and the largest log-prob difference;
    - ``linalg_fp32_vs_float64``, ``ctc_fp32_vs_float64``: ops_c1b2's
      cases in fp32 against float64, relative to the largest value;
    - ``custom``: the custom_softmax example's accuracy before and after
      its epochs."""
    ctx = mt.cpu()
    out = {}
    cfg = dict(cs.MOE, num_layers=2)
    S, V = cfg["seq_len"], cfg["vocab_size"]
    x, y = cs.lm_batch(np.random.default_rng(cs.SEED + 70), 1, S, V)
    mod = cs.moe_module(mt, ctx, cfg, 1)
    mt.random.seed(cs.SEED)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": cs.MOE_LR})
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=ctx)],
                            [mt.nd.array(y, ctx=ctx)])
    losses = []
    for _ in range(cs.MOE_WARMUP + cs.MOE_STEPS):
        cs.train_step(mod, batch)
        losses.append(float(mod.get_outputs()[0].asnumpy()))
    out["moe_train"] = dict(layers=2, batch=1, losses=losses,
                            drop=losses[0] - losses[-1])
    print(json.dumps(out["moe_train"]), flush=True)
    del mod

    params = cs.gpt2_params(mt.models.transformer_lm(**cfg), cs.SEED + 72)
    x, y = cs.lm_batch(np.random.default_rng(cs.SEED + 73), 1, S, V)
    f32 = cs.moe_fp32_step(mt, ctx, params, x, y)
    f64 = _moe_float64_step(params, x, y)
    out["moe_fp32_vs_float64"] = dict(
        loss32=f32[0], loss64=f64[0], **cs.moe_fp32_compare(f32, f64,
                                                            params))
    print(json.dumps(out["moe_fp32_vs_float64"]), flush=True)

    out["moe_decode_vs_lm"] = cs.moe_decode_vs_lm(mt, ctx)
    print(json.dumps(out["moe_decode_vs_lm"]), flush=True)

    worst = {}
    for i, (name, arrays, attrs) in enumerate(cs.linalg_cases(
            np.random.default_rng(cs.SEED + 81))):
        o32, g32 = cs.linalg_run(torch, mt, name, arrays, attrs, "cpu", i)
        o64, g64 = cs.linalg_run(torch, mt, name,
                                 [a.astype(np.float64) for a in arrays],
                                 attrs, "cpu", i)
        worst[name] = dict(
            out=max(cs.rel_diff(a, b) for a, b in zip(o32, o64)),
            grad=max(cs.rel_diff(a, b) for a, b in zip(g32, g64)))
    out["linalg_fp32_vs_float64"] = worst
    print(json.dumps(worst), flush=True)

    x, lab = cs.ctc_inputs(np.random.default_rng(cs.SEED + 84))
    l32, g32 = cs.ctc_run(torch, mt, x, lab, "cpu")
    l64, g64 = cs.ctc_run(torch, mt, x.astype(np.float64), lab, "cpu")
    out["ctc_fp32_vs_float64"] = dict(loss=cs.rel_diff(l32, l64),
                                      grad=cs.rel_diff(g32, g64))
    print(json.dumps(out["ctc_fp32_vs_float64"]), flush=True)

    before, after, secs = cs.custom_softmax_run(mt, ctx,
                                                cs.OPS_CUSTOM_EPOCHS)
    out["custom"] = dict(before=before, after=after, gain=after - before,
                         seconds=secs)
    return out


def part_moe_bf16():
    """The JAX package's bf16 MoE routing fault (ROADMAP §3): its
    ``_top_k_gating`` on seeded normal logits at T 8192 (GPT-2 small's
    batch 8 x 1024), E 8, k 1, capacity 2048, in float32 and bfloat16:
    the capacity slots holding a token and the most tokens in one slot;
    and the port's ``top_k_route`` on the same logits."""
    from mxnet_tpu.ops import moe as jmoe
    from mxnet_tpu_torch.ops import moe as tmoe
    T, E, C = 8192, 8, 2048
    logits = np.random.default_rng(0).standard_normal((T, E)).astype(
        np.float32)
    out = {}
    for dt in ("float32", "bfloat16"):
        dispatch, _ = jmoe._top_k_gating(jnp.asarray(logits,
                                                     getattr(jnp, dt)), 1, C)
        per_slot = np.asarray(dispatch, np.float32).sum(axis=0)
        experts, slots, keep, _ = tmoe.top_k_route(
            torch.tensor(logits).to(getattr(torch, dt)), 1, C)
        flat = (experts * C + slots)[keep]
        out[dt] = dict(jax_slots_used=int((per_slot > 0).sum()),
                       jax_most_tokens_in_a_slot=int(per_slot.max()),
                       port_slots_used=int(flat.unique().numel()),
                       port_tokens_kept=int(keep.sum()))
    return out


def part_c8():
    """The numbers behind chip_smoke.py's C8 phases; see the module
    docstring."""
    import tempfile
    ctx = mt.cpu()
    out = {}
    torch.manual_seed(0)
    shape, batch = (3, 112, 112), cs.RESNET_BATCH
    mod, clock, feed, x, y, _ = cs.lars_fit(mt, ctx, batch, shape,
                                            cs.LARS_STEPS, lambda: None,
                                            lambda m: None)
    feed.close()
    out["lars_fit"] = dict(batch=batch, image=list(shape),
                           losses=clock.losses,
                           drop=float(np.mean(clock.losses[:4])
                                      - np.mean(clock.losses[-4:])))
    print(json.dumps(out["lars_fit"]), flush=True)
    checks = cs.lars_reshape_checks(torch, mt, mod, x, y, batch,
                                    cs.LARS_EVAL_BATCH)
    args, aux = mod.get_params()
    f32 = mt.mod.Module(mod.symbol, context=ctx)
    f32.bind(data_shapes=[("data", (batch,) + shape)],
             label_shapes=[("softmax_label", (batch,))],
             for_training=False)
    f32.init_params(arg_params=args, aux_params=aux)
    p32 = cs.eval_rows(mt, f32, x, batch)
    p16 = cs.eval_rows(mt, mod, x, batch)
    out["lars_eval"] = dict(
        checks, bf16_vs_fp32_rel_diff=float((p16 - p32).abs().max()
                                            / p32.abs().max()))
    print(json.dumps(out["lars_eval"], default=str), flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        prefix = os.path.join(workdir, "lars")
        mod.save_checkpoint(prefix, 1)
        del mod, f32
        ft, clock, feed, trunk, _, _ = cs.finetune_fit(
            mt, ctx, prefix, 1, batch, shape, cs.FT_STEPS, lambda: None)
        feed.close()
    out["finetune"] = dict(batch=batch, fixed=len(trunk),
                           losses=clock.losses,
                           drop=float(np.mean(clock.losses[:4])
                                      - np.mean(clock.losses[-4:])))
    print(json.dumps(out["finetune"]), flush=True)
    del ft

    shapes = cs.resnet_param_shapes(mt)
    w, grads = cs.opt_inputs(shapes, cs.SEED + 94, cs.FE_STEPS)

    wr, gr = cs.bf16_rounded(w), [cs.bf16_rounded(g) for g in grads]
    budgets = {}
    for name in cs.FE_OPTIMIZERS:
        if name == "sgld":
            continue
        f32, _ = cs.opt_run(mt, name, w, grads, ctx)
        f64, _ = cs.opt_run(mt, name, {k: v.astype(np.float64)
                                       for k, v in w.items()},
                            [{k: v.astype(np.float64) for k, v in g.items()}
                             for g in grads], ctx, "float64")
        d32 = max(cs.opt_distance(torch, f32, f64, w).values())
        del f32, f64
        mp, _ = cs.opt_run(mt, name, w, grads, ctx, "bfloat16", True)
        m64, _ = cs.opt_run(mt, name, {k: v.astype(np.float64)
                                       for k, v in wr.items()},
                            [{k: v.astype(np.float64) for k, v in g.items()}
                             for g in gr], ctx, "float64")
        dmp = max(cs.opt_distance(torch, mp, m64, wr).values())
        del mp, m64
        budgets[name] = (d32, dmp)
        print(json.dumps({name: budgets[name]}), flush=True)
    out["optimizer_budgets"] = budgets
    return out


def part_c3():
    import io as _io
    from PIL import Image
    from mxnet_tpu_torch import native
    gen = torch.Generator().manual_seed(cs.SEED + 100)
    sizes, jpegs, mads = [], [], []
    for sigma in np.linspace(*cs.REC_NOISE, 8):
        img = cs.rec_image(torch, torch.device("cpu"), gen, 375, 500, sigma)
        buf = _io.BytesIO()
        Image.fromarray(img.numpy()).save(buf, "JPEG",
                                          quality=cs.REC_QUALITY)
        jpegs.append(buf.getvalue())
        sizes.append(len(jpegs[-1]) / 1024)
    for j in jpegs:
        pil = np.asarray(Image.open(_io.BytesIO(j)).convert("RGB"))
        ours, _ = native.decode_jpeg_batch([j], 375, 500, 3, 1)
        mads.append(float(np.abs(ours[0].astype(int) - pil).mean()))
    from mxnet_tpu_torch.ops import image_augment as ia
    full = [native.decode_jpeg_batch([j], 375, 500, 3, 1)[0][0]
            for j in jpegs]
    images = ia.DecodedImages.from_arrays(full)
    n = len(jpegs)
    zero, no = np.zeros(n, np.int64), np.zeros(n, bool)
    down = {}
    for size in (256, 187, 128, 64):
        host, _ = native.decode_augment_batch(jpegs, size, size, size,
                                              size, zero, zero, no, 0, 1,
                                              3, 1)
        card = ia.augment_plain(images, zero, zero, no, (size, size),
                                (size, size)).numpy()
        d = 1
        while d < 8 and 375 // (d * 2) >= size and 500 // (d * 2) >= size:
            d *= 2
        diff = np.abs(host - card)
        down[size] = dict(d=d, mean=float(diff.mean()),
                          max=float(diff.max()))
    return {"record_kb": dict(mean=float(np.mean(sizes)),
                              min=float(min(sizes)), max=float(max(sizes)),
                              noise=list(cs.REC_NOISE),
                              kb_range=list(cs.REC_KB_RANGE)),
            "libjpeg_vs_pil": dict(mean=float(np.mean(mads)),
                                   max=float(max(mads)),
                                   tol=cs.DECODE_MAD_TOL),
            "dct_downscale": down}


def part_c2():
    """The numbers behind chip_smoke.py's sparse_linear and two_tower_fit
    phases, with their own data and loops on the CPU at the card's
    sizes: each loss curve (the phases require the mean of the last
    losses below the first ones'), and the CPU's seconds a step."""
    out = {}
    cols, vals, y = cs.sparse_dataset(cs.SEED + 80)
    B, k = cs.SPARSE_BATCH, cs.SPARSE_NNZ
    host = [(mt.nd.sparse.csr_matrix(
        (vals[b * B:(b + 1) * B].reshape(-1),
         cols[b * B:(b + 1) * B].reshape(-1),
         np.arange(0, B * k + 1, k)), shape=(B, cs.SPARSE_FEATURES),
        ctx=mt.cpu()), mt.nd.array(y[b * B:(b + 1) * B], ctx=mt.cpu()))
        for b in range(cs.SPARSE_BATCHES)]
    steps = cs.SPARSE_WARMUP + cs.SPARSE_STEPS
    for name in ("sgd", "adam"):
        t0 = time.monotonic()
        run = cs.LinearRun(mt, name, mt.cpu())
        losses, row = cs.linear_steps(torch, run, host, steps)
        secs = (time.monotonic() - t0) / steps
        run64 = cs.LinearRun(mt, name, mt.cpu(), dtype="float64")
        cs.linear_steps(torch, run64, host, steps)
        out["sparse_linear_" + name] = dict(
            losses=losses, densified=row["densified"], s_per_step=secs,
            max_abs_vs_float64=[float((a.double() - b).abs().max()) for a, b
                                in zip(run.tensors(), run64.tensors())])
    u, i, yl = cs.tower_stream(torch, cs.SEED + 90, device="cpu")
    B = cs.TOWER_BATCH
    runs = {}
    for dtype in ("float32", "float64"):
        batches = [tuple(mt.nd.array(a[b * B:(b + 1) * B], ctx=mt.cpu(),
                                     dtype=dtype) for a in (u, i, yl))
                   for b in range(cs.TOWER_BATCHES)]
        init = None if not runs else runs["float32"][0]
        towers, trainer = cs.tower_pair(mt, mt.cpu(), init, dtype)
        start = [t.weight.data().asnumpy() for t in towers]
        t0 = time.monotonic()
        losses, _ = cs.tower_steps(torch, mt, towers, trainer, batches,
                                   cs.TOWER_WARMUP + cs.TOWER_STEPS)
        runs[dtype] = (start, [t.weight.data().asnumpy() for t in towers],
                       losses, (time.monotonic() - t0) / len(losses))
    out["two_tower"] = dict(
        losses=runs["float32"][2], lr=cs.TOWER_LR,
        s_per_step=runs["float32"][3],
        max_abs_vs_float64=[float(np.abs(a - b).max()) for a, b in zip(
            runs["float32"][1], runs["float64"][1])])
    return out


def part_e1():
    """The numbers behind chip_smoke.py's dist_async_lm_fit phase: the LM
    at full width cut to 2 layers, batch TRAIN_BATCH x 1024, fp32 on the
    CPU, trained by Module.fit over dist_async (two in-process servers of
    the port, Adam TRAIN_LR on them) with 2-bit pushes at
    DIST_ASYNC_THRESHOLD, for the phase's 7 compressed steps: each step's
    loss and the share of the gradient's values that fired; and the
    quantiles of the first gradient's absolute values (the threshold's
    choice)."""
    import os
    from mxnet_tpu_torch.kvstore_server import KVStoreServer
    cfg = dict(cs.GPT2_SMALL, num_layers=2)
    S, V, B = cfg["seq_len"], cfg["vocab_size"], cs.TRAIN_BATCH
    steps = cs.DIST_ASYNC_FIT_STEPS + cs.DIST_ASYNC_RUN_STEPS + 1
    sym = mt.models.transformer_lm(**cfg)
    rng = np.random.default_rng(cs.SEED + 130)
    xs, ys = zip(*[cs.lm_batch(rng, B, S, V) for _ in range(steps)])
    srvs = [KVStoreServer(server_id=i, num_workers=1) for i in range(2)]
    for srv in srvs:
        srv.start_background()
    os.environ["MXT_SERVER_URIS"] = ",".join(
        f"127.0.0.1:{srv.port}" for srv in srvs)
    os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"] = str(cs.DIST_BIGARRAY_BOUND)
    try:
        kv = mt.kv.create("dist_async")
        kv.set_gradient_compression({"type": "2bit",
                                     "threshold": cs.DIST_ASYNC_THRESHOLD})
        rec = cs.PushRecorder(kv)
        it = mt.io.NDArrayIter({"data": np.concatenate(xs)},
                               {"softmax_label": np.concatenate(ys)},
                               batch_size=B)
        mod = mt.mod.Module(sym, context=mt.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mt.random.seed(cs.SEED)
        mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                              magnitude=2.0))
        losses, fired, quantiles = [], [], {}

        def batch_end(param):
            if not quantiles:
                a = np.concatenate([np.abs(mod._exec.grad_dict[n].asnumpy())
                                    .ravel() for n in mod._update_names()])
                quantiles.update({f"top_{q}": float(np.quantile(a, 1 - q))
                                  for q in (0.01, 0.02, 0.05, 0.1)})
            f, n = rec.fired()
            fired.append(f / n)
            rec.rows.clear()
            losses.append(cs.lm_step_loss(
                torch, mod, param.locals["data_batch"].label[0]))
        rec.on = True
        mod.fit(it, num_epoch=1, kvstore=kv, optimizer="adam",
                optimizer_params={"learning_rate": cs.TRAIN_LR},
                batch_end_callback=batch_end)
        kv.close(stop_servers=True)
    finally:
        for srv in srvs:
            srv.stop()
    return dict(threshold=cs.DIST_ASYNC_THRESHOLD, layers=2, batch=B,
                losses=losses, drop=losses[0] - losses[-1],
                fired_share=fired, first_grad_abs_quantiles=quantiles)


def part_e1_sync():
    """The mechanism behind chip_smoke.py's dist_sync_fit gate: the LM of
    that phase (full width, 2 layers, fp32, its seeded weights and global
    batches of 8) on the CPU, trained DIST_SYNC_STEPS Adam steps two ways
    from the same weights: on each whole batch, and on the sum of its two
    halves' gradients (what the two ranks' all-reduce gives).  At the
    first step: the gradients' distance in norm and the share of values
    whose sign differs; after each step: the distance of the two
    updates (weights minus the initial ones) relative to the update's
    norm, the quantity the phase gates."""
    sym, params = cs.dist_sync_lm(mt)
    batches = cs.dist_sync_batches()
    b = cs.DIST_SYNC_BATCH
    S = batches[0][0].shape[1]
    mods = {}

    def grads(weights, x, y, rows):
        n = len(rows)
        if n not in mods:
            mod = mt.mod.Module(sym, context=mt.cpu())
            mod.bind([mt.io.DataDesc("data", (n, S), np.int32)],
                     [mt.io.DataDesc("softmax_label", (n, S), np.int32)])
            mod.init_params(arg_params=params)
            mods[n] = mod
        mod = mods[n]
        for k, v in weights.items():
            mod._exec.arg_dict[k]._set_data(v._data.clone())
        mod.forward(mt.io.DataBatch([mt.nd.array(x[rows], ctx=mt.cpu())],
                                    [mt.nd.array(y[rows], ctx=mt.cpu())]),
                    is_train=True)
        mod.backward()
        return {k: mod._exec.grad_dict[k].asnumpy() for k in weights}

    def fresh():
        w = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}
        opt = mt.optimizer.Adam(learning_rate=cs.DIST_SYNC_LR,
                                rescale_grad=1.0 / (2 * b))
        return w, mt.optimizer.get_updater(opt)
    (w1, u1), (w2, u2) = fresh(), fresh()

    def norm(d):
        return float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                 for v in d.values())))
    out = {"update_rel_distance": []}
    for step, (x, y) in enumerate(batches):
        g1 = grads(w1, x, y, np.arange(2 * b))
        h = [grads(w2, x, y, np.arange(r * b, (r + 1) * b))
             for r in range(2)]
        g2 = {k: h[0][k] + h[1][k] for k in g1}
        if step == 0:
            out["grad_rel_distance"] = norm(
                {k: g1[k] - g2[k] for k in g1}) / norm(g1)
            out["sign_flip_share"] = sum(
                int((np.sign(g1[k]) != np.sign(g2[k])).sum())
                for k in g1) / sum(v.size for v in g1.values())
        for i, k in enumerate(sorted(g1)):
            u1(i, mt.nd.array(g1[k], ctx=mt.cpu()), w1[k])
            u2(i, mt.nd.array(g2[k], ctx=mt.cpu()), w2[k])
        d1 = {k: w1[k].asnumpy() - params[k] for k in w1}
        d2 = {k: w2[k].asnumpy() - params[k] for k in w2}
        out["update_rel_distance"].append(
            norm({k: d1[k] - d2[k] for k in d1}) / norm(d1))
    return out


PARTS = {"resnet": part_resnet, "deep_bn": part_deep_bn, "gluon": part_gluon,
         "decode_vs_lm": part_decode_vs_lm, "beam": part_beam,
         "vit": part_vit, "zoo": part_zoo, "rnn": part_rnn, "ssd": part_ssd,
         "zoo_data": part_zoo_data, "c1b2": part_c1b2,
         "moe_bf16": part_moe_bf16, "c8": part_c8, "c3": part_c3,
         "c2": part_c2, "e1": part_e1, "e1_sync": part_e1_sync}

if __name__ == "__main__":
    for part in sys.argv[1:] or list(PARTS):
        t0 = time.monotonic()
        res = PARTS[part]()
        if res is not None:
            print(json.dumps({"part": part,
                              "seconds": time.monotonic() - t0, **res}),
                  flush=True)
