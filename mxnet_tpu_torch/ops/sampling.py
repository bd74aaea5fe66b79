"""Random sampling ops.

PyTorch counterpart of ``mxnet_tpu/ops/sampling.py`` (reference:
src/operator/random/sample_op.cc, multisample_op.cc): ``_random_*``
draw ``shape`` values from a distribution of scalar parameters,
``_sample_*`` one distribution per element of their parameter arrays,
each drawing ``shape`` values (output ``param.shape + shape``),
``_sample_multinomial`` draws from the rows of a probability array
(with their log-probabilities under ``get_prob``), ``_shuffle`` permutes
along axis 0.  The JAX package's conventions hold: the negative binomial
NB(k, p) is a gamma(k, scale (1 - p) / p) - Poisson mixture, the
generalized NB(mu, alpha) a gamma(1 / alpha, scale mu alpha) - Poisson
mixture that is Poisson(mu) where alpha is 0, and ``_sample_gamma``'s
beta is a scale.

Every draw takes the ``generator`` the executor or the imperative
dispatcher hands a ``needs_rng`` op (one a bound graph, one a device
imperatively, both seeded by ``mx.random.seed``); none comes from
torch's global generator.  The streams are not the JAX package's, so the
two packages agree in distribution, not in value.  Shape inference runs
these ops on meta tensors without a generator and gets empty outputs.
"""
from __future__ import annotations

import torch

from .registry import register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dt(dtype):
    return getattr(torch, str(getattr(dtype, "name", dtype) or "float32"))


def _meta(device):
    return device is not None and torch.device(device).type == "meta"


def _gamma(alpha, generator):
    """Gamma(alpha, scale 1) draws of alpha's shape (float32)."""
    return torch._standard_gamma(alpha, generator=generator)


def _poisson(lam, generator):
    return torch.poisson(lam, generator=generator)


# ---------------------------------------------------------------------------
# scalar parameters: _random_*
# ---------------------------------------------------------------------------
def _scalar_op(name, aliases, defaults, draw):
    """Register ``_random_<name>``: ``draw(shape, device, generator,
    **params)`` gives float32 (or, for randint, integer) values."""
    @register(f"_random_{name}", needs_rng=True, differentiable=False,
              aliases=aliases, attr_defaults=defaults)
    def _op(shape=(), dtype=defaults["dtype"], device=None, generator=None,
            **kw):
        params = {k: kw.get(k, v) for k, v in defaults.items()
                  if k not in ("shape", "dtype")}
        shp = _shape(shape)
        if _meta(device):
            return torch.empty(shp, dtype=_dt(dtype), device="meta")
        return draw(shp, device, generator, **params).to(_dt(dtype))
    _op.__name__ = f"_random_{name}"
    return _op


def _full(shp, value, device):
    return torch.full(shp, float(value), dtype=torch.float32, device=device)


_scalar_op("uniform", ("uniform", "random_uniform"),
           {"low": 0.0, "high": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, low, high: torch.rand(
               shp, generator=g, device=dev) * (high - low) + low)
_scalar_op("normal", ("normal", "random_normal"),
           {"loc": 0.0, "scale": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, loc, scale: torch.randn(
               shp, generator=g, device=dev) * scale + loc)
_scalar_op("gamma", ("random_gamma",),
           {"alpha": 1.0, "beta": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, alpha, beta: _gamma(
               _full(shp, alpha, dev), g) * beta)
_scalar_op("exponential", ("random_exponential",),
           {"lam": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, lam: torch.empty(
               shp, device=dev).exponential_(generator=g) / lam)
_scalar_op("poisson", ("random_poisson",),
           {"lam": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, lam: _poisson(_full(shp, lam, dev), g))
_scalar_op("negative_binomial", ("random_negative_binomial",),
           {"k": 1, "p": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, k, p: _poisson(
               _gamma(_full(shp, k, dev), g) * ((1 - p) / p), g))


def _gnb_rate(mu, alpha, g):
    """The Poisson rate of GNB(mu, alpha): gamma(1/alpha) * mu * alpha,
    or mu where alpha is 0."""
    shape = torch.where(alpha > 0, 1.0 / torch.clamp_min(alpha, 1e-12),
                        torch.ones_like(alpha))
    return torch.where(alpha > 0, _gamma(shape, g) * mu * alpha, mu)


_scalar_op("generalized_negative_binomial",
           ("random_generalized_negative_binomial",),
           {"mu": 1.0, "alpha": 1.0, "shape": (), "dtype": "float32"},
           lambda shp, dev, g, mu, alpha: _poisson(_gnb_rate(
               _full(shp, mu, dev), _full(shp, alpha, dev), g), g))


@register("_random_randint", needs_rng=True, differentiable=False,
          aliases=("random_randint",),
          attr_defaults={"low": 0, "high": 1, "shape": (), "dtype": "int32"})
def _randint(low=0, high=1, shape=(), dtype="int32", device=None,
             generator=None, **kw):
    shp = _shape(shape)
    if _meta(device):
        return torch.empty(shp, dtype=_dt(dtype), device="meta")
    return torch.randint(int(low), int(high), shp, generator=generator,
                         device=device, dtype=_dt(dtype))


# ---------------------------------------------------------------------------
# one distribution a parameter element: _sample_*
# ---------------------------------------------------------------------------
def _sample_op(name, arg_names, draw):
    """Register ``_sample_<name>``: the parameters broadcast to
    ``param.shape + shape``; ``draw(params, generator)`` gives float32."""
    @register(f"_sample_{name}", needs_rng=True, differentiable=False,
              arg_names=arg_names,
              attr_defaults={"shape": (), "dtype": "float32"})
    def _op(*params, shape=(), dtype="float32", generator=None, **kw):
        ex = _shape(shape)
        out_shape = tuple(params[0].shape) + ex
        if params[0].device.type == "meta":
            return torch.empty(out_shape, dtype=_dt(dtype), device="meta")
        ps = [p.float().reshape(tuple(p.shape) + (1,) * len(ex))
              .expand(out_shape) for p in params]
        return draw(ps, generator).to(_dt(dtype))
    _op.__name__ = f"_sample_{name}"
    return _op


def _rand_like(x, g):
    return torch.rand(x.shape, generator=g, device=x.device)


_sample_op("uniform", ["low", "high"],
           lambda ps, g: _rand_like(ps[0], g) * (ps[1] - ps[0]) + ps[0])
_sample_op("normal", ["mu", "sigma"],
           lambda ps, g: torch.randn(ps[0].shape, generator=g,
                                     device=ps[0].device) * ps[1] + ps[0])
_sample_op("gamma", ["alpha", "beta"],
           lambda ps, g: _gamma(ps[0].contiguous(), g) * ps[1])
_sample_op("exponential", ["lam"],
           lambda ps, g: torch.empty(ps[0].shape, device=ps[0].device)
           .exponential_(generator=g) / ps[0])
_sample_op("poisson", ["lam"],
           lambda ps, g: _poisson(ps[0].contiguous(), g))
_sample_op("negative_binomial", ["k", "p"],
           lambda ps, g: _poisson(_gamma(ps[0].contiguous(), g)
                                  * (1.0 - ps[1]) / ps[1], g))
_sample_op("generalized_negative_binomial", ["mu", "alpha"],
           lambda ps, g: _poisson(_gnb_rate(ps[0], ps[1], g), g))


@register("_sample_multinomial", needs_rng=True, differentiable=False,
          aliases=("sample_multinomial",), arg_names=["data"],
          attr_defaults={"shape": (), "get_prob": False, "dtype": "int32"})
def _multinomial(data, shape=(), get_prob=False, dtype="int32",
                 generator=None, **kw):
    """Rows of ``data`` are distributions (normalised here); ``shape``
    draws a row: output ``data.shape[:-1] + shape`` (a 1-D ``data`` with
    no shape: one draw, a scalar).  ``get_prob`` adds the draws' log
    probabilities, log(max(p, 1e-37)), in data's dtype."""
    ex = _shape(shape)
    out_shape = tuple(data.shape[:-1]) + ex
    if data.device.type == "meta":
        out = torch.empty(out_shape, dtype=_dt(dtype), device="meta")
        return (out, torch.empty(out_shape, dtype=data.dtype,
                                 device="meta")) if get_prob else out
    n = 1
    for s in ex:
        n *= s
    rows = data.reshape(-1, data.shape[-1]).float()
    idx = torch.multinomial(torch.clamp_min(rows, 1e-37), n,
                            replacement=True, generator=generator)
    out = idx.reshape(out_shape).to(_dt(dtype))
    if get_prob:
        lp = torch.log(torch.clamp_min(rows, 1e-37)).gather(1, idx)
        return out, lp.reshape(out_shape).to(data.dtype)
    return out


@register("_shuffle", needs_rng=True, differentiable=False,
          aliases=("shuffle",), arg_names=["data"], attr_defaults={})
def _shuffle(data, generator=None, **kw):
    """A random permutation of data along axis 0."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]
