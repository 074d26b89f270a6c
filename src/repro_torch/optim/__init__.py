"""Optimizers, learning-rate schedules and gradient compression (the
reference's ``repro.optim``)."""
from .adamw import Optimizer, adamw, apply_updates, global_norm, sgd_momentum
from .compress import compress_decompress, dequantize_int8, init_ef_state, quantize_int8
from .schedule import constant, warmup_cosine, warmup_linear_decay

__all__ = [
    "Optimizer",
    "adamw",
    "sgd_momentum",
    "apply_updates",
    "global_norm",
    "compress_decompress",
    "init_ef_state",
    "quantize_int8",
    "dequantize_int8",
    "constant",
    "warmup_cosine",
    "warmup_linear_decay",
]
