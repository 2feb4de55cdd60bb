"""Public wrapper of the RG-LRU scan (the port of
``repro/kernels/rglru/ops.py``)."""
from __future__ import annotations

from ..flash_attention.ops import check_executor
from ..rwkv6.ops import no_autograd
from .ref import rglru_ref
from .rglru import rglru_scan


def rglru(a, b, *, executor: str = "auto"):
    """a, b [B, T, C] -> h [B, T, C] in a's dtype, by executor: ``auto`` is
    the kernel on a CUDA device and the plain version on the CPU; ``cuda``
    is the kernel and raises for CPU tensors; ``reference`` is the plain
    version on any device (the card's comparison)."""
    check_executor(executor)
    no_autograd("the RG-LRU scan", a, b)
    if executor == "cuda" and a.device.type != "cuda":
        raise ValueError(f"executor='cuda' needs CUDA tensors, got "
                         f"{a.device}")
    return (rglru_ref if executor == "reference" else rglru_scan)(a, b)


#: The sequential plain version (JAX's oracle is its associative scan).
rglru_oracle = rglru_ref
