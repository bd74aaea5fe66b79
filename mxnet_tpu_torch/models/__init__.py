"""Symbolic model zoo (subset): the transformer LM."""
from . import transformer  # noqa: F401
from .transformer import transformer_lm
