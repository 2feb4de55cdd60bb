"""Public wrapper: model layout [B, T, H, hd] over the kernel's
[B, H, T, hd] (the port of ``repro/kernels/rwkv6/ops.py``).  The layouts
differ only by a ``transpose`` view: the kernels take strides, so nothing
is copied.

Under autograd, :func:`wkv` runs :class:`WKV`: the forward kernel (on the
route ``wkv_plan`` picks), then the backward kernel (the port's own: JAX
differentiates its model's ``lax.scan``), which recomputes the states from
the saved inputs.
"""
from __future__ import annotations

import torch

from ..flash_attention.ops import check_executor
from .ref import wkv_bwd_ref, wkv_ref
from .rwkv6 import wkv_bhtd, wkv_bwd_bhtd


def _t(x):
    return x.transpose(1, 2)


class WKV(torch.autograd.Function):
    """Differentiable WKV recurrence in the kernels' layout ([B, H, T, hd]):
    forward and backward both run the kernels (the plain versions when
    ``reference`` is set, or for CPU tensors).  Saves r, k, v, w, u and S0,
    and no state: the backward walks the states again."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0, reference):
        # an unused output's gradient arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        y, S = (wkv_ref if reference else wkv_bhtd)(r, k, v, w, u, S0)
        ctx.save_for_backward(r, k, v, w, u, S0)
        ctx.reference = reference
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        r, k, v, w, u, S0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype)
        if dy.stride(3) != 1:
            dy = dy.contiguous()
        bwd = wkv_bwd_ref if ctx.reference else wkv_bwd_bhtd
        dr, dk, dv, dw, du, dS0 = bwd(r, k, v, w, u, S0, dy, dS)
        return (dr, dk, dv, dw, du.to(u.dtype),
                None if S0 is None else dS0.to(S0.dtype), None)


def wkv(r, k, v, w, u, S0=None, *, executor: str = "auto"):
    """r, k, v, w [B, T, H, hd]; u [H, hd]; S0 [B, H, hd, hd] or None (the
    TPU kernel's zero start) -> (y [B, T, H, hd] in r's dtype, S_final
    [B, H, hd, hd] float32), by executor: ``auto`` is the kernel on a CUDA
    device and the plain version on the CPU; ``cuda`` is the kernel and
    raises for CPU tensors; ``reference`` is the plain version on any
    device (the card's comparison).  When grad is enabled and an input
    requires it, the call goes through :class:`WKV`, whose backward follows
    the same executor."""
    check_executor(executor)
    if executor == "cuda" and r.device.type != "cuda":
        raise ValueError(f"executor='cuda' needs CUDA tensors, got "
                         f"{r.device}")
    args = (_t(r), _t(k), _t(v), _t(w), u, S0)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in args):
        y, S = WKV.apply(*args, executor == "reference")
    else:
        y, S = (wkv_ref if executor == "reference" else wkv_bhtd)(*args)
    return _t(y), S


def wkv_oracle(r, k, v, w, u):
    """The plain version in the model layout, from a zero state: y only (as
    JAX's ``wkv_oracle``)."""
    return _t(wkv_ref(_t(r), _t(k), _t(v), _t(w), u)[0])
