"""Model zoo of the port: the dense LM transformers so far.

Models are pure functions over parameter dicts declared once as
``ParamSpec`` trees (``base.py``).
"""
from . import attention, transformer
from .base import init_params, param_count, params_from_jax

__all__ = ["attention", "transformer", "init_params", "param_count", "params_from_jax"]
