"""The RWKV-6 WKV recurrence: ``csrc/wkv.cu`` and its backward
``csrc/wkv_bwd.cu`` beside their plain versions (the port of
``repro/kernels/rwkv6``)."""
from .ops import WKV, wkv, wkv_oracle  # noqa: F401
from .ref import wkv_bwd_ref, wkv_ref  # noqa: F401
from .rwkv6 import wkv_bhtd, wkv_bwd_bhtd  # noqa: F401
