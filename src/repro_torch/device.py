"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the CPU
only when the caller asks for it (the CPU tests do).  Asking for CUDA on a
machine without it raises: nothing here quietly carries on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if CUDA is asked for and
    absent.  On a CUDA device, float32 matrix products run in full float32
    (matmul precision "highest", TF32 off for matmul and cuDNN): the
    reference scores in true float32 and the parity checks depend on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda|cpu)")
    return dev
