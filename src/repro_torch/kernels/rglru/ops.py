"""Public wrapper of the RG-LRU scan (the port of
``repro/kernels/rglru/ops.py``).

Under autograd, :func:`rglru` runs :class:`RGLRUScan`: the forward kernel,
then the backward kernel (a reverse scan, the port's own: JAX
differentiates its associative scan in XLA) from the saved ``a`` and
``h``.
"""
from __future__ import annotations

import torch

from ..flash_attention.ops import check_executor
from .ref import rglru_bwd_ref, rglru_ref
from .rglru import rglru_scan, rglru_scan_bwd


class RGLRUScan(torch.autograd.Function):
    """Differentiable ``h_t = a_t h_{t-1} + b_t``: forward and backward both
    run the kernels (the plain versions when ``reference`` is set, or for
    CPU tensors).  Saves a and h."""

    @staticmethod
    def forward(ctx, a, b, reference):
        h = (rglru_ref if reference else rglru_scan)(a, b)
        ctx.save_for_backward(a, h)
        ctx.reference = reference
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        if g.stride(2) != 1:
            g = g.contiguous()
        bwd = rglru_bwd_ref if ctx.reference else rglru_scan_bwd
        da, db = bwd(a, h, g)
        return da.to(a.dtype), db.to(a.dtype), None


def rglru(a, b, *, executor: str = "auto"):
    """a, b [B, T, C] -> h [B, T, C] in a's dtype, by executor: ``auto`` is
    the kernel on a CUDA device and the plain version on the CPU; ``cuda``
    is the kernel and raises for CPU tensors; ``reference`` is the plain
    version on any device (the card's comparison).  When grad is enabled
    and an input requires it, the call goes through :class:`RGLRUScan`,
    whose backward follows the same executor."""
    check_executor(executor)
    if executor == "cuda" and a.device.type != "cuda":
        raise ValueError(f"executor='cuda' needs CUDA tensors, got "
                         f"{a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b, executor == "reference")
    return (rglru_ref if executor == "reference" else rglru_scan)(a, b)


#: The sequential plain version (JAX's oracle is its associative scan).
rglru_oracle = rglru_ref
