"""Module API (subset): ``BaseModule`` and ``Module``."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
