"""Flash attention: ``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention.cu`` (forward, bf16 and float32), and
``csrc/flash_attention_bwd_sm90.cu`` and ``csrc/flash_attention_bwd.cu``
(backward, bf16 and float32), each beside its plain version
(the port of ``repro/kernels/flash_attention``), and the autograd Function
that joins them."""
from .flash_attention import flash_attention_bhtd  # noqa: F401
from .flash_attention_bwd import flash_attention_bwd_bhtd  # noqa: F401
from .ops import FlashAttention, flash_attention, flash_attention_ref  # noqa: F401
from .ref import attention_bwd_ref, attention_ref  # noqa: F401
