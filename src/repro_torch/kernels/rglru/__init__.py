"""The RG-LRU gated linear recurrence: ``csrc/rglru.cu`` beside its plain
version (the port of ``repro/kernels/rglru``)."""
from .ops import RGLRUScan, rglru, rglru_oracle  # noqa: F401
from .ref import rglru_bwd_ref, rglru_ref  # noqa: F401
from .rglru import rglru_scan, rglru_scan_bwd  # noqa: F401
