"""One serving replica of the port on the CPU, as a child process of
``tests/test_torch_fleet_chaos.py``; not collected.  It serves the
one-layer softmax model of ``tests/dist/dist_fleet_chaos.py`` on the
port ``FLEET_PORT`` names until it is killed: by its armed fault plan
(``MXNET_FI_KILL_PROCESS_AFTER``: SIGKILL, no goodbye bundle) or by the
parent's closing SIGTERM, which dumps its health bundle into
``MXNET_HEALTH_DIR``.

``DMLC_ROLE`` is set AFTER the import: with it in the spawn env the
package would start a plain parameter server at import time; the
health bundle reads the role at dump time, so the postmortem still sees
a labelled server process."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

FEAT, HIDDEN = 4, 3


def model(pkg):
    """The symbol, its parameters and the numpy weights."""
    rs = np.random.RandomState(0)
    w = rs.randn(HIDDEN, FEAT).astype(np.float32)
    b = rs.randn(HIDDEN).astype(np.float32)
    data = pkg.sym.Variable('data')
    fc = pkg.sym.FullyConnected(data, num_hidden=HIDDEN, name='fc')
    sym = pkg.sym.SoftmaxOutput(fc, name='softmax')
    return sym, {'fc_weight': pkg.nd.NDArray(w),
                 'fc_bias': pkg.nd.NDArray(b)}, w, b


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import health, serving
    os.environ["DMLC_ROLE"] = "server"
    health.reconfigure()      # the bundle is server-<DMLC_SERVER_ID>
    sym, params, _w, _b = model(mt)
    rep = serving.ServingReplica(
        sym, {'data': (FEAT,)}, params, buckets=[1, 2, 4, 8],
        port=int(os.environ["FLEET_PORT"]), queue_depth=512,
        max_wait_s=0.002, warmup=True, ctx=mt.cpu())
    rep.start_background()
    print("READY %d" % rep.port, flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
