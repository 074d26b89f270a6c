"""Flash attention: the hand-written Hopper kernels (``csrc/flash_attention_wgmma.cu``
for bfloat16 at d = 128, ``csrc/flash_attention.cu`` for the rest), their
plain PyTorch version and the reference's oracle, and the wrapper that
dispatches between kernel and plain version by the device of the inputs."""
from .ops import flash_attention, flash_attention_mma, launches, reset_launches, route
from .ref import flash_attention_ref, mha_ref

__all__ = ["flash_attention", "flash_attention_mma", "flash_attention_ref", "launches", "mha_ref",
           "reset_launches", "route"]
