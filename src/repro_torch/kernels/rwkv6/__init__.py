"""The RWKV-6 WKV recurrence: ``csrc/wkv.cu`` beside its plain version (the
port of ``repro/kernels/rwkv6``)."""
from .ops import wkv, wkv_oracle  # noqa: F401
from .ref import wkv_ref  # noqa: F401
from .rwkv6 import wkv_bhtd  # noqa: F401
