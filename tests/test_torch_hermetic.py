"""The PyTorch port stands alone: importing ``mxnet_tpu_torch`` pulls in
neither JAX nor the JAX package, builds no kernel and starts no CUDA
context, and no file of the port (nor ``chip_smoke.py``) imports them."""
import ast
import json
import os
import subprocess
import sys
import torch_threads  # noqa: F401,E402  a worker's share of the cores

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
                 "models.squeezenet", "models.densenet",
                 "ndarray.sparse", "kvstore"]


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


# the data-IO slice's modules
C3_MODULES = ["recordio", "native", "image_record_iter", "image",
              "image.image", "image.detection", "image.nvjpeg",
              "ops.image_augment"]


def test_data_io_imports_hermetically_and_builds_at_first_use(tmp_path):
    """Importing the port builds neither the host data-path libraries nor
    a kernel and starts no CUDA context; a record iterator on the CPU
    then builds the host libraries (and no kernel), loads no jax and no
    mxnet_tpu."""
    code = (
        "import json, sys, numpy as np, torch\n"
        "import mxnet_tpu_torch as mt\n"
        "from mxnet_tpu_torch.image import nvjpeg\n"
        "from mxnet_tpu_torch.ops import image_augment\n"
        "at_import = sorted(mt.native._libs)\n"
        f"path = {str(tmp_path / 'd.rec')!r}\n"
        "w = mt.recordio.MXRecordIO(path, 'w')\n"
        "for i in range(4):\n"
        "    img = np.full((20, 18, 3), 40 * i, np.uint8)\n"
        "    w.write(mt.recordio.pack_img((0, float(i), i, 0), img))\n"
        "w.close()\n"
        "it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),\n"
        "                           batch_size=2, device=mt.cpu())\n"
        "n = sum(1 for _ in it)\n"
        "print(json.dumps({'mods': sorted(sys.modules), 'n': n,\n"
        "  'at_import': at_import, 'native': sorted(mt.native._libs),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'libs': sorted(mt.cuda_lib._libs)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["at_import"] == []
    assert out["native"] == ["jpeg_io", "rec_io"] and out["n"] == 2
    assert out["cuda_init"] is False
    assert out["libs"] == []
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in C3_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        path = os.path.join("mxnet_tpu_torch", *mod.split("."))
        assert path + ".py" in scanned or \
            os.path.join(path, "__init__.py") in scanned, mod


# the checkpoint (C4) and observability (C6) slice's modules
C4_C6_MODULES = ["checkpoint", "compat_serialization", "tracing", "health",
                 "monitor", "visualization", "test_utils", "notebook",
                 "notebook.callback", "contrib", "contrib.autograd",
                 "contrib.tensorboard", "contrib.torch", "profiler"]


def test_checkpoint_and_observability_import_start_nothing(tmp_path):
    """Importing the port with every observability knob set (a trace
    directory, a health bundle directory) loads the C4 and C6 modules,
    no jax and no mxnet_tpu, and starts no CUDA context, no thread and
    no hook: no ``sys.excepthook`` / ``threading.excepthook``, no SIGTERM
    handler, no ``atexit`` callback."""
    code = (
        "import atexit, json, signal, sys, threading, torch\n"
        "n0, th0 = atexit._ncallbacks(), threading.active_count()\n"
        "import mxnet_tpu_torch as mt\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'atexit': atexit._ncallbacks() - n0,\n"
        "  'threads': threading.active_count() - th0,\n"
        "  'excepthook': sys.excepthook is sys.__excepthook__,\n"
        "  'thread_hook': threading.excepthook is threading.__excepthook__,\n"
        "  'sigterm': signal.getsignal(signal.SIGTERM) == signal.SIG_DFL,\n"
        "  'libs': sorted(mt.cuda_lib._libs)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, MXNET_TRACE="1",
               MXNET_TRACE_DIR=str(tmp_path / "trace"),
               MXNET_HEALTH_DIR=str(tmp_path / "health"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["cuda_init"] is False and out["libs"] == []
    assert out["atexit"] == 0 and out["threads"] == 0
    assert out["excepthook"] and out["thread_hook"] and out["sigterm"]
    assert not os.path.exists(str(tmp_path / "trace"))
    assert not os.path.exists(str(tmp_path / "health"))
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in C4_C6_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        path = os.path.join("mxnet_tpu_torch", *mod.split("."))
        assert path + ".py" in scanned or \
            os.path.join(path, "__init__.py") in scanned, mod


# the distributed plane (E1): loaded by the import, scanned by the AST
# test, and silent until used
E1_MODULES = ["kvstore", "kvstore_server", "distributed", "compression",
              "wirecodec", "faultinject", "membership", "analysis.hb"]


def test_distributed_plane_imports_start_nothing():
    """The port's import loads the distributed plane's modules and
    starts no thread, opens no socket and creates no
    CUDA context; a process launched as a parameter server
    (``DMLC_ROLE=server``) serves from the import on, and a kStopServer
    command ends it with exit code 0."""
    code = (
        "import json, os, sys, threading, torch\n"
        "def socks():\n"
        "    fds = os.listdir('/proc/self/fd')\n"
        "    return sum(os.readlink('/proc/self/fd/' + f).startswith(\n"
        "        'socket:') for f in fds if os.path.exists(\n"
        "        '/proc/self/fd/' + f))\n"
        "s0, th0 = socks(), threading.active_count()\n"
        "import mxnet_tpu_torch as mt\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'sockets': socks() - s0,\n"
        "  'threads': threading.active_count() - th0}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DMLC_ROLE", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["cuda_init"] is False
    assert out["sockets"] == 0 and out["threads"] == 0
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in E1_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        assert os.path.join("mxnet_tpu_torch",
                            *mod.split(".")) + ".py" in scanned, mod

    import socket
    import time
    from mxnet_tpu_torch.kvstore_server import (K_STOP_SERVER, _recv_msg,
                                                _send_msg)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    env.update(DMLC_ROLE="server", DMLC_SERVER_ID="0", DMLC_NUM_WORKER="1",
               MXT_SERVER_URIS=f"127.0.0.1:{port}")
    proc = subprocess.Popen([sys.executable, "-c",
                             "import mxnet_tpu_torch\nprint('returned')"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                assert time.time() < deadline and proc.poll() is None, \
                    proc.stderr.read() if proc.poll() is not None else ""
                time.sleep(0.2)
        _send_msg(s, ("command", K_STOP_SERVER, None))
        assert _recv_msg(s) == ("ok", None)
        s.close()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "listening on port" in out and "returned" not in out


def test_serving_wire_imports_start_nothing():
    """Importing the serving wire (the replica, the client, the fleet)
    loads no JAX and nothing of the JAX package, and starts no thread,
    no socket and no CUDA context."""
    code = (
        "import json, os, sys, threading, torch\n"
        "def socks():\n"
        "    fds = os.listdir('/proc/self/fd')\n"
        "    return sum(os.readlink('/proc/self/fd/' + f).startswith(\n"
        "        'socket:') for f in fds if os.path.exists(\n"
        "        '/proc/self/fd/' + f))\n"
        "s0, th0 = socks(), threading.active_count()\n"
        "import mxnet_tpu_torch.serving as srv\n"
        "from mxnet_tpu_torch.serving import (ServingReplica,\n"
        "    ServingClient, FleetClient, publish_version)\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'all': sorted(srv.__all__),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'sockets': socks() - s0,\n"
        "  'threads': threading.active_count() - th0}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DMLC_ROLE", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in out["mods"] if _forbidden(m)] == []
    assert out["cuda_init"] is False
    assert out["sockets"] == 0 and out["threads"] == 0
    scanned = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in ("serving.replica", "serving.client", "serving.fleet"):
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
        assert os.path.join("mxnet_tpu_torch",
                            *mod.split(".")) + ".py" in scanned, mod
    assert "publish_version" in out["all"]
