"""Flash-attention forward: ``csrc/flash_attention.cu`` and its plain
version (the port of ``repro/kernels/flash_attention``; the backward waits
for the training slice)."""
from .flash_attention import flash_attention_bhtd  # noqa: F401
from .ops import flash_attention, flash_attention_ref  # noqa: F401
from .ref import attention_ref  # noqa: F401
