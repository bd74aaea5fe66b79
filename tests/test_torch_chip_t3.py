"""CPU rehearsals of ``chip_smoke.py``'s two T3 / E2 phases, run through
the script's own functions at a small size before any card run:

* ``phase_fleet_serve`` over a small cifar-stem ResNet's checkpoint
  (Module.fit + do_checkpoint, as ``resnet_fit_checkpoint`` writes
  ResNet-50's), two replicas on the CPU behind a FleetClient, the storm
  of 256 requests (a quarter of it here) with one replica stopped
  part-way: zero failures, every reply within the phase's tolerance of
  a direct predict of its rows at a bucket that covers them, all traffic after the stop on the
  survivor;
* ``phase_elastic_train_serve`` over a small LM (width 32, 2 layers,
  its embedding striped by a bound of 256 values): two elastic server
  processes, server 1 SIGKILLed after exactly the envelope count
  ``elastic_kill_acks`` derives from the wire (the phase checks the
  count it saw), the final weights equal to the servers' SGD replayed
  on the host bit for bit, and the replica's refresh across the repair
  equal to a direct predict on the pulled weights bit for bit.

On the CPU no kernel launches (the phase expects zero counts there).
Each case stays well inside 60 s."""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from torch_dist import ROOT
import torch_threads  # noqa: F401  a worker's share of the cores

sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_slate():
    """Each case starts with the port's flight recorder clean and no
    fault plan armed: a replica's self-reported verdict is its process's
    roll-up, so channel poison left by an earlier test file in the same
    worker would read CRITICAL to the fleet."""
    mt.health.reset()
    mt.faultinject.reset()
    yield
    mt.faultinject.reset()


def test_fleet_serve_phase_on_a_small_resnet(tmp_path, monkeypatch):
    # a quarter of the card's storm over buckets up to 8: bf16 forwards
    # of 32 rows are slow on the CPU
    monkeypatch.setattr(cs, "FLEET_REQUESTS", 64)
    monkeypatch.setattr(cs, "FLEET_STOP_AFTER", 24)
    monkeypatch.setattr(cs, "FLEET_THREADS", 16)
    monkeypatch.setattr(cs, "FLEET_BUCKETS", (1, 2, 4, 8))
    shape = (3, 16, 16)
    prefix = str(tmp_path / "resnet8")
    with mt.cpu():
        sym = mt.models.get_symbol("resnet", num_layers=8, num_classes=10,
                                   image_shape="3,16,16")
        it = cs.SyntheticIter(mt, 8, shape, 2, cs.SEED + 9)
        mod = mt.mod.Module(sym, context=mt.cpu(), compute_dtype="bfloat16")
        mt.random.seed(cs.SEED)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=cs.RESNET_OPT,
                initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                                  factor_type="in",
                                                  magnitude=2),
                epoch_end_callback=mt.callback.do_checkpoint(prefix))
        counts = cs.phase_fleet_serve(torch, mt, prefix, shape=shape,
                                      ctx=mt.cpu())
    assert not any(counts.values())


def test_elastic_train_serve_phase_on_a_small_lm(monkeypatch):
    monkeypatch.setattr(cs, "DIST_BIGARRAY_BOUND", 256)
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.5")
    cfg = dict(vocab_size=50, seq_len=16, num_layers=2, d_model=32,
               num_heads=4, d_ff=64)
    with mt.cpu():
        counts = cs.phase_elastic_train_serve(torch, mt, cfg=cfg,
                                              ctx=mt.cpu())
    assert not any(counts.values())


def test_kill_point_counts_striped_and_coalesced_keys():
    """``elastic_kill_acks`` by hand: a key on each server, a striped key
    with a stripe on each, a small key on server 1 that coalesces."""
    from mxnet_tpu_torch import membership as mem
    names, shapes, i = [], [], 0
    while len(names) < 2:      # two small keys on server 1, one on 0
        k = f"k{i}"
        if mem.server_index(k, 2) == 1 or not names:
            names.append(k)
            shapes.append((2, 2))
        i += 1
    names.append("big")
    shapes.append((100, 8))     # 800 values > the bound of 256: striped
    on1 = sum(mem.server_index(k, 2) == 1 for k in names[:2])
    stripes1 = sum(mem.stripe_server_index("big", j, 2) == 1
                   for j in range(len(mem.stripe_plan(
                       "big", (100, 8), 2, 256)) - 1))
    setup = 2 * (on1 + stripes1) + 2
    per_step = (1 if on1 else 0) + stripes1 + (on1 + stripes1)
    assert cs.elastic_kill_acks(names, shapes, bound=256, kill_step=2) \
        == setup + 2 * per_step


def test_dist_sync_inputs_round_trip_through_the_handover(tmp_path):
    """``dist_sync_fit``'s workers read the parent's seeded weights and
    batches from its file, equal to what they used to build themselves
    (``gpt2_params`` and ``dist_sync_batches``), dtypes included."""
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3), dtype=np.float32),
              "b_gamma": np.ones(3, np.float32)}
    glob = [cs.lm_batch(rng, 4, 8, 50) for _ in range(3)]
    cs.dist_sync_handover(str(tmp_path), params, glob)
    got_p, got_g = cs.dist_sync_inputs(str(tmp_path), timeout=5)
    assert set(got_p) == set(params)
    for k in params:
        np.testing.assert_array_equal(got_p[k], params[k])
        assert got_p[k].dtype == params[k].dtype
    for (x, y), (gx, gy) in zip(glob, got_g):
        np.testing.assert_array_equal(gx, x)
        np.testing.assert_array_equal(gy, y)
        assert gx.dtype == x.dtype and gy.dtype == y.dtype
    assert not os.path.exists(tmp_path / "inputs.tmp.npz")
