"""Flash attention: the hand-written Hopper kernel (``csrc/flash_attention.cu``),
its plain PyTorch version and the reference's oracle, and the wrapper that
dispatches between kernel and plain version by the device of the inputs."""
from .ops import flash_attention, launches, reset_launches
from .ref import flash_attention_ref, mha_ref

__all__ = ["flash_attention", "flash_attention_ref", "launches", "mha_ref", "reset_launches"]
