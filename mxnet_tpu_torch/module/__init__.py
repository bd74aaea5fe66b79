"""Module API (subset): ``BaseModule``, ``Module`` and
``BucketingModule``."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
