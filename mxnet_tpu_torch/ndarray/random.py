"""``nd.random`` — the sampling namespace (reference:
python/mxnet/ndarray/random.py).

PyTorch counterpart of ``mxnet_tpu/ndarray/random.py``, with its
argument mapping: scalar parameters call the ``_random_*`` ops (on
``ctx``, default the current context), NDArray parameters the
``_sample_*`` ops (one distribution an element, on the parameters'
device); ``exponential(scale)`` draws with rate ``lam = 1 / scale``.
The draws come from the device's generator, which ``mx.random.seed``
reseeds (``mxnet_tpu_torch/random.py``).
"""
from __future__ import annotations

from .ndarray import _invoke, NDArray


def _pick(name, params, scalars, shape, dtype, ctx, out):
    """``_sample_<name>`` over NDArray parameters, else ``_random_<name>``
    with ``scalars`` as attributes."""
    if isinstance(params[0], NDArray):
        return _invoke(f"_sample_{name}", list(params),
                       {"shape": shape or (), "dtype": dtype}, out=out)
    return _invoke(f"_random_{name}", [],
                   dict(scalars, shape=shape or (), dtype=dtype), out=out,
                   ctx=ctx)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    return _pick("uniform", (low, high), {"low": low, "high": high}, shape,
                 dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    return _pick("normal", (loc, scale), {"loc": loc, "scale": scale},
                 shape, dtype, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, tuple(shape), dtype, ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    return _pick("gamma", (alpha, beta), {"alpha": alpha, "beta": beta},
                 shape, dtype, ctx, out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    if isinstance(scale, NDArray):
        return _invoke("_sample_exponential", [1.0 / scale],
                       {"shape": shape or (), "dtype": dtype}, out=out)
    return _invoke("_random_exponential", [],
                   {"lam": 1.0 / scale, "shape": shape or (),
                    "dtype": dtype}, out=out, ctx=ctx)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    return _pick("poisson", (lam,), {"lam": lam}, shape, dtype, ctx, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    return _invoke("_random_negative_binomial", [],
                   {"k": k, "p": p, "shape": shape or (), "dtype": dtype},
                   out=out, ctx=ctx)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None, **kw):
    return _invoke("_random_generalized_negative_binomial", [],
                   {"mu": mu, "alpha": alpha, "shape": shape or (),
                    "dtype": dtype}, out=out, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None, **kw):
    return _invoke("_random_randint", [],
                   {"low": low, "high": high, "shape": shape or (),
                    "dtype": dtype}, out=out, ctx=ctx)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _invoke("_sample_multinomial", [data],
                   {"shape": shape or (), "get_prob": get_prob,
                    "dtype": dtype})


def shuffle(data, **kw):
    return _invoke("_shuffle", [data], {})
