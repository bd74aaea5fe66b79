"""No silent CPU: without CUDA, the port's entry points raise unless the
caller asks for the CPU, and ``chip_smoke.py`` fails without printing a
result.  (On a machine with a GPU these tests skip: they are about its
absence.)"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import BucketedPredictor
import torch_threads  # noqa: F401,E402  a worker's share of the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is about its absence")


def _lm():
    net = mt.models.transformer_lm(20, 4, num_layers=1, d_model=16,
                                   num_heads=2)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(1, 4), softmax_label=(1, 4))[0]))
    params = {n: np.zeros(s, np.float32) for n, s in shapes.items()
              if n not in ("data", "softmax_label")}
    return net, params


def test_default_context_is_gpu0():
    assert mt.current_context() == mt.gpu(0)
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
    assert mt.current_context() == mt.gpu(0)
    assert mt.cpu().torch_device() == torch.device("cpu")


def test_entry_points_raise_without_cuda(no_cuda):
    net, params = _lm()
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        mt.gpu(0).torch_device()
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        BucketedPredictor(net, {"data": (4,), "softmax_label": (4,)},
                          params)
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        mt.params_from_numpy(params, {}, None, net,
                             {"data": (1, 4), "softmax_label": (1, 4)})
    # asking for the CPU works
    pred = BucketedPredictor(net, {"data": (4,), "softmax_label": (4,)},
                             params, ctx=mt.cpu(), buckets=[1])
    assert pred.predict({"data": np.zeros((1, 4)),
                         "softmax_label": np.zeros((1, 4))})[1][0].shape \
        == (4, 20)


def test_chip_smoke_fails_without_cuda(no_cuda, tmp_path):
    alone = tmp_path / "chip_smoke.py"       # the script and nothing else
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        res = subprocess.run([sys.executable, script],
                             cwd=os.path.dirname(script), env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
        assert "CUDA is not available" in res.stderr
