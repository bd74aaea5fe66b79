"""The PyTorch port stands alone: importing ``mxnet_tpu_torch`` pulls in
neither JAX nor the JAX package, builds no kernel and starts no CUDA
context, and no file of the port (nor ``chip_smoke.py``) imports them."""
import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(mod):
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_cuda_context():
    code = (
        "import json, sys, torch\n"
        "import mxnet_tpu_torch\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'libs': sorted(mxnet_tpu_torch.cuda_lib._libs)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in out["mods"] if _forbidden(m)]
    assert bad == [], bad
    assert out["cuda_init"] is False
    assert "mxnet_tpu_torch" in out["mods"]
    assert out["libs"] == []       # no kernel library loaded or built


def _sources():
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return files


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    files = _sources()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, ROOT), m)
                          for m in mods if _forbidden(m)]
    assert offenders == []


def test_kernel_sources_are_cuda_for_sm90a():
    from mxnet_tpu_torch import cuda_lib
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    for src in cuda_lib.SOURCES:
        path = os.path.join(cuda_lib.CSRC_DIR, src)
        with open(path) as f:
            text = f.read()
        assert "__global__" in text and 'extern "C"' in text
        assert "scaled_dot_product_attention" not in text


# the decode / zoo slice's modules: each is loaded by ``import
# mxnet_tpu_torch`` (so the import test above holds them to no jax and no
# CUDA context) and is among the sources the AST scan reads
SLICE_MODULES = ["ops.reduce", "models.generation", "models.vit",
                 "models.mlp", "models.lenet", "models.alexnet",
                 "models.vgg", "models.resnext", "models.inception_bn",
                 "models.inception_v3", "models.mobilenet",
                 "models.squeezenet", "models.densenet"]


def test_slice_modules_are_loaded_and_scanned():
    code = ("import json, sys, torch\n"
            "import mxnet_tpu_torch\n"
            "print(json.dumps({'mods': sorted(sys.modules),\n"
            "  'cuda_init': torch.cuda.is_initialized()}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["cuda_init"] is False
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in SLICE_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        assert os.path.join("mxnet_tpu_torch",
                            *mod.split(".")) + ".py" in scanned, mod


# the imperative / Gluon slice's modules
GLUON_MODULES = ["autograd", "ndarray.register", "gluon", "gluon.parameter",
                 "gluon.block", "gluon.trainer", "gluon.loss", "gluon.utils",
                 "gluon.nn", "gluon.nn.basic_layers", "gluon.nn.conv_layers",
                 "gluon.model_zoo",
                 "gluon.model_zoo.vision", "gluon.model_zoo.vision.resnet"]


def test_gluon_and_autograd_import_and_run_hermetically():
    """Importing ``mxnet_tpu_torch.gluon`` and ``.autograd`` and training
    a step of a Gluon net on the CPU loads no jax and no mxnet_tpu,
    starts no CUDA context and builds no kernel."""
    code = (
        "import json, sys, torch\n"
        "import mxnet_tpu_torch.gluon as gluon\n"
        "import mxnet_tpu_torch.autograd as autograd\n"
        "import mxnet_tpu_torch as mt\n"
        "with mt.cpu():\n"
        "    net = gluon.nn.HybridSequential()\n"
        "    net.add(gluon.nn.Conv2D(4, 3), gluon.nn.BatchNorm(),\n"
        "            gluon.nn.Dense(3))\n"
        "    net.initialize()\n"
        "    net.hybridize()\n"
        "    tr = gluon.Trainer(net.collect_params(), 'sgd')\n"
        "    x = mt.nd.ones((2, 3, 6, 6))\n"
        "    with autograd.record():\n"
        "        loss = gluon.loss.L2Loss()(net(x), mt.nd.zeros((2, 3)))\n"
        "    loss.backward()\n"
        "    tr.step(2)\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'libs': sorted(mt.cuda_lib._libs)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["cuda_init"] is False
    assert out["libs"] == []
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in GLUON_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        path = os.path.join("mxnet_tpu_torch", *mod.split("."))
        assert path + ".py" in scanned or \
            os.path.join(path, "__init__.py") in scanned, mod


# the RNN / rtc slice's modules
RNN_MODULES = ["ops.rnn", "ops.sequence", "rnn", "rnn.rnn_cell", "rnn.io",
               "module.bucketing_module", "gluon.rnn", "gluon.rnn.rnn_cell",
               "gluon.rnn.rnn_layer", "gluon.contrib", "gluon.contrib.nn",
               "gluon.contrib.rnn", "gluon.contrib.rnn.conv_rnn_cell",
               "gluon.contrib.rnn.rnn_cell", "rtc"]


def test_rnn_and_rtc_import_and_run_hermetically():
    """Importing the RNN and rtc modules and training a BucketingModule
    step of a fused LSTM on the CPU loads no jax and no mxnet_tpu,
    starts no CUDA context and builds nothing: ``rtc`` compiles only
    when a kernel is asked for, and nothing here asks."""
    code = (
        "import json, os, sys, torch\n"
        "import mxnet_tpu_torch as mt\n"
        "from mxnet_tpu_torch import rtc, rnn, gluon\n"
        "def sym_gen(T):\n"
        "    cell = mt.rnn.FusedRNNCell(4, num_layers=2, prefix='l_')\n"
        "    e = mt.sym.Embedding(mt.sym.Variable('data'), input_dim=9,\n"
        "                         output_dim=3)\n"
        "    out, _ = cell.unroll(T, e, merge_outputs=True)\n"
        "    out = mt.sym.FullyConnected(mt.sym.Reshape(out, shape=(-1, 4)),\n"
        "                                num_hidden=9)\n"
        "    lab = mt.sym.Reshape(mt.sym.Variable('softmax_label'),\n"
        "                         shape=(-1,))\n"
        "    return mt.sym.SoftmaxOutput(out, lab), ('data',), \\\n"
        "        ('softmax_label',)\n"
        "it = rnn.BucketSentenceIter([[1, 2, 3]] * 4 + [[4, 5]] * 4, 2,\n"
        "                            buckets=[2, 3], dtype='int32')\n"
        "mod = mt.mod.BucketingModule(sym_gen, 3, context=mt.cpu())\n"
        "mod.fit(it, num_epoch=1, initializer=mt.init.Xavier())\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'libs': sorted(mt.cuda_lib._libs),\n"
        "  'rtc_built': os.path.isdir(os.path.join(\n"
        "      os.path.dirname(mt.cuda_lib.BUILD_DIR), 'rtc'))}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    before = os.path.isdir(os.path.join(ROOT, "build", "rtc"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["cuda_init"] is False
    assert out["libs"] == []
    assert out["rtc_built"] == before
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in RNN_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        path = os.path.join("mxnet_tpu_torch", *mod.split("."))
        assert path + ".py" in scanned or \
            os.path.join(path, "__init__.py") in scanned, mod


# the zoo / data slice's modules
ZOO_DATA_MODULES = ["gluon.data", "gluon.data.dataset", "gluon.data.sampler",
                    "gluon.data.dataloader", "gluon.data.vision",
                    "gluon.model_zoo.vision.alexnet",
                    "gluon.model_zoo.vision.vgg",
                    "gluon.model_zoo.vision.squeezenet",
                    "gluon.model_zoo.vision.inception",
                    "gluon.model_zoo.vision.densenet",
                    "gluon.model_zoo.vision.mobilenet"]


def test_gluon_data_and_zoo_import_and_run_hermetically():
    """A zoo network fed by a ``DataLoader`` with worker threads, trained
    a step on the CPU, and the new dense ops: no jax, no mxnet_tpu, no
    CUDA context, no kernel built."""
    code = (
        "import json, sys, numpy as np, torch\n"
        "import mxnet_tpu_torch as mt\n"
        "from mxnet_tpu_torch import gluon, autograd\n"
        "with mt.cpu():\n"
        "    net = gluon.model_zoo.vision.get_model('squeezenet1.1',\n"
        "                                           classes=3)\n"
        "    net.initialize()\n"
        "    net.hybridize()\n"
        "    tr = gluon.Trainer(net.collect_params(), 'sgd')\n"
        "    ds = gluon.data.ArrayDataset(np.ones((4, 3, 32, 32), 'f'),\n"
        "                                 np.zeros(4, 'f'))\n"
        "    for x, y in gluon.data.DataLoader(ds, batch_size=2,\n"
        "                                      num_workers=2):\n"
        "        with autograd.record():\n"
        "            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)\n"
        "        loss.backward()\n"
        "        tr.step(2)\n"
        "    mt.nd.UpSampling(mt.nd.ones((1, 1, 2, 2)), scale=2)\n"
        "    mt.nd.space_to_depth(mt.nd.ones((1, 1, 2, 2)), block_size=2)\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'libs': sorted(mt.cuda_lib._libs)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["cuda_init"] is False
    assert out["libs"] == []
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in ZOO_DATA_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        path = os.path.join("mxnet_tpu_torch", *mod.split("."))
        assert path + ".py" in scanned or \
            os.path.join(path, "__init__.py") in scanned, mod
