"""The work ``chip_smoke.py`` starts early to keep its clock, on the CPU:
the CPU references of zoo_predict, gluon_zoo_fp32_card_vs_cpu and
front_end, computed by a process of their own (``chip_smoke.py
--cpu-refs DIR``) from the script's start, are the values each phase's
own code computes in-process on the same inputs, bit for bit (here on
small networks and parameter shapes in place of the card's), and a
process that dies without them fails the phase; the kernels' build,
started on a thread before torch is imported, builds the libraries the
package loads and is collected by ``phase_build``'s waiting half."""
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from torch_dist import ROOT
import torch_threads  # noqa: F401  a worker's share of the cores

sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

SHAPES = [("conv0_weight", (8, 3, 3, 3)), ("bn0_gamma", (8,)),
          ("bn0_beta", (8,)), ("fc1_weight", (10, 72)), ("fc1_bias", (10,))]


def test_cpu_reference_process_equals_the_inline_runs(tmp_path,
                                                      monkeypatch):
    """The helper (run here in this process, on the helper's thread
    count) writes what each phase's own code gives in-process on the
    same inputs, bit for bit: zoo_predict's CPU logits, the zoo fp32
    step's weights and CPU step, and every optimizer's runs in both
    precisions (small networks and shapes here)."""
    monkeypatch.setattr(cs, "resnet_param_shapes", lambda mt: SHAPES)
    monkeypatch.setattr(cs, "ZOO", (("mlp", dict(num_classes=10),
                                     (1, 28, 28)),))
    monkeypatch.setattr(cs, "ZOO_NETS", (("squeezenet1.1", 64),))
    threads = torch.get_num_threads()
    try:
        assert cs.cpu_refs(str(tmp_path)) == 0
        assert torch.get_num_threads() == cs.FE_CPU_REF_THREADS

        class Done:
            returncode = 0

            @staticmethod
            def poll():
                return 0
        refs = (Done, str(tmp_path))
        name, _, net, args, aux, x = cs.zoo_case(mt, 0)
        want = cs.zoo_predict(mt, cs.logits_graph(mt, net), args, aux, x,
                              mt.cpu())
        got = np.load(cs.zoo_cpu_ref_path(str(tmp_path), 0))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        zname, side = cs.ZOO_NETS[0]
        values, (loss, grads, params, _secs, head) = cs.zoo_fp32_ref(refs,
                                                                     zname)
        want_values = cs.zoo_numpy_params(mt, zname, side, cs.SEED + 50)
        assert sorted(values) == sorted(want_values)
        for k in values:
            assert np.array_equal(values[k].view(np.int32),
                                  want_values[k].view(np.int32)), k
        xb, yb = cs.zoo_fp32_batch(0, side)
        wl, wg, wp, _, whead = cs.zoo_fp32_step(mt, mt.cpu(), zname,
                                                want_values, xb, yb)
        assert loss == wl and head == whead
        for got_d, want_d in ((grads, wg), (params, wp)):
            assert sorted(got_d) == sorted(want_d)
            for k in got_d:
                assert np.array_equal(got_d[k].view(np.int32),
                                      want_d[k].view(np.int32)), k
        inputs = cs.fe_inputs(SHAPES)
        n = 0
        for oname in cs.FE_OPTIMIZERS:
            if oname == "sgld":
                continue
            for mp in (False, True):
                got = cs.fe_cpu_ref(torch, refs, oname, mp, SHAPES,
                                    timeout=1)
                want, _ = cs.opt_run(mt, oname, *inputs[mp], mt.cpu())
                for k, _s in SHAPES:
                    assert torch.equal(got[k].view(torch.int32),
                                       want[k].view(torch.int32)), \
                        (oname, mp, k)
                n += 1
        assert n == 2 * (len(cs.FE_OPTIMIZERS) - 1)
    finally:
        torch.set_num_threads(threads)


def test_a_dead_reference_process_fails_the_phase(tmp_path):
    """The helper's log tail names the failure; nothing is computed in
    its place."""
    log = tmp_path / "cpu_refs.log"
    log.write_text("Traceback: boom\n")

    class Dead:
        returncode = 1

        @staticmethod
        def poll():
            return 1
    with pytest.raises(RuntimeError, match="boom"):
        cs.fe_cpu_ref(torch, (Dead, str(tmp_path)), "sgd", False, SHAPES,
                      timeout=5)


def test_started_build_is_collected(monkeypatch):
    """start_build's thread runs cuda_lib.build_all once; its error, as
    nvcc's would be, is raised where the build phase collects it."""
    calls = []

    def fake_build_all():
        calls.append(time.monotonic())
        raise mt.MXNetError("kernel build failed: nvcc not found")
    monkeypatch.setattr(mt.cuda_lib, "build_all", fake_build_all)
    started = cs.start_build(mt.cuda_lib)
    with pytest.raises(mt.MXNetError, match="nvcc not found"):
        cs.phase_build(mt, started)
    assert len(calls) == 1


def test_early_builder_builds_the_packages_libraries():
    """The cuda_lib the script loads before torch (from the package's file,
    under a name of its own) builds every source into the path, flags
    and hash the package's cuda_lib loads it from; here, without a card,
    the script starts no early build."""
    import os
    cl = cs.load_cuda_lib(os.path.join(ROOT, "mxnet_tpu_torch"))
    assert cl is not mt.cuda_lib and "torch" not in vars(cl)
    assert cl.NVCC_FLAGS == mt.cuda_lib.NVCC_FLAGS
    for src in mt.cuda_lib.SOURCES + tuple(mt.cuda_lib.SHIMS):
        assert cl._lib_path(src) == mt.cuda_lib._lib_path(src)
    if not os.path.exists("/dev/nvidia0"):
        assert cs.kernel_builder() is None


def test_dynamo_import_thread_leaves_shape_inference_as_it_is():
    """The early import only moves torch._dynamo's import: a graph's
    inferred shapes are the same before and after it."""
    net = mt.models.transformer_lm(vocab_size=64, seq_len=16, num_layers=1,
                                   d_model=32, num_heads=4, d_ff=64)
    before = net.infer_shape(data=(2, 16), softmax_label=(2, 16))
    cs.start_dynamo_import().join(timeout=120)
    assert "torch._dynamo" in sys.modules
    assert net.infer_shape(data=(2, 16), softmax_label=(2, 16)) == before
