"""Model zoo of the port: the LM transformers (dense and MoE) and the recsys models.

Models are pure functions over parameter dicts declared once as
``ParamSpec`` trees (``base.py``).
"""
from . import attention, moe, recsys, transformer
from .base import init_params, param_count, params_from_jax

__all__ = ["attention", "moe", "recsys", "transformer", "init_params", "param_count", "params_from_jax"]
