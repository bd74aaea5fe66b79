"""``sym.random`` — the symbolic sampling namespace (reference:
python/mxnet/symbol/random.py, the symbol mirror of ndarray/random.py).

PyTorch counterpart of ``mxnet_tpu/symbol/random.py``: each function
composes the op its ``nd.random`` twin calls (scalar parameters
``_random_*``, Symbol parameters ``_sample_*``).  In a bound graph the
draws come from the executor's generator.
"""
from __future__ import annotations

from .symbol import Symbol


def _op(name):
    from .. import symbol as _sym
    f = getattr(_sym, name, None)
    if f is None:
        raise AttributeError(f"symbol op {name!r} not registered")
    return f


def _both_symbol(a, b, fname):
    """Tensor-parameter path requires BOTH params symbolic — a mixed
    scalar/Symbol call would silently drop the Symbol into an unused
    kwarg of the scalar op (the reference's _random_helper raises the
    same way, symbol/random.py)."""
    sa, sb = isinstance(a, Symbol), isinstance(b, Symbol)
    if sa != sb:
        raise ValueError(
            f"mx.sym.random.{fname}: distribution parameters must be "
            "both Symbols or both numbers; wrap the scalar, e.g. "
            "mx.sym.zeros(shape) + value")
    return sa


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", **kw):
    if _both_symbol(low, high, "uniform"):
        return _op("_sample_uniform")(low, high, shape=shape or (),
                                      dtype=dtype, **kw)
    return _op("_random_uniform")(low=low, high=high, shape=shape or (),
                                  dtype=dtype, **kw)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", **kw):
    if _both_symbol(loc, scale, "normal"):
        return _op("_sample_normal")(loc, scale, shape=shape or (),
                                     dtype=dtype, **kw)
    return _op("_random_normal")(loc=loc, scale=scale, shape=shape or (),
                                 dtype=dtype, **kw)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", **kw):
    if _both_symbol(alpha, beta, "gamma"):
        return _op("_sample_gamma")(alpha, beta, shape=shape or (),
                                    dtype=dtype, **kw)
    return _op("_random_gamma")(alpha=alpha, beta=beta, shape=shape or (),
                                dtype=dtype, **kw)


def exponential(scale=1.0, shape=None, dtype="float32", **kw):
    if isinstance(scale, Symbol):   # single-parameter family: no mix risk
        return _op("_sample_exponential")(1.0 / scale, shape=shape or (),
                                          dtype=dtype, **kw)
    return _op("_random_exponential")(lam=1.0 / scale, shape=shape or (),
                                      dtype=dtype, **kw)


def poisson(lam=1.0, shape=None, dtype="float32", **kw):
    if isinstance(lam, Symbol):
        return _op("_sample_poisson")(lam, shape=shape or (),
                                      dtype=dtype, **kw)
    return _op("_random_poisson")(lam=lam, shape=shape or (),
                                  dtype=dtype, **kw)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", **kw):
    # same surface as mx.nd.random.negative_binomial (scalar params only)
    return _op("_random_negative_binomial")(k=k, p=p, shape=shape or (),
                                            dtype=dtype, **kw)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", **kw):
    return _op("_random_generalized_negative_binomial")(
        mu=mu, alpha=alpha, shape=shape or (), dtype=dtype, **kw)


def randint(low, high, shape=None, dtype="int32", **kw):
    return _op("_random_randint")(low=low, high=high, shape=shape or (),
                                  dtype=dtype, **kw)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _op("_sample_multinomial")(data, shape=shape or (),
                                      get_prob=get_prob, dtype=dtype, **kw)


def shuffle(data, **kw):
    return _op("_shuffle")(data, **kw)
