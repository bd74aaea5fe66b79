"""Symbolic API (``sym``)."""
from .. import ops as _ops  # noqa: F401  registers every op
from .symbol import (Symbol, Node, Variable, var, Group, load,
                     load_json, arange, zeros, ones)
from .register import init_symbol_module
from ..base import ContribNamespace as _ContribNS

init_symbol_module(globals())
contrib = _ContribNS(globals())
