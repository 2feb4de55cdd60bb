"""Public wrapper: model layout [B, T, H, hd] over the kernel's
[B, H, T, hd] (the port of ``repro/kernels/rwkv6/ops.py``).  The layouts
differ only by a ``transpose`` view: the kernel takes strides, so nothing
is copied."""
from __future__ import annotations

import torch

from ..flash_attention.ops import check_executor
from .ref import wkv_ref
from .rwkv6 import wkv_bhtd

#: The ROADMAP item that brings gradients through the WKV recurrence.
TRAINING_ITEM = "ROADMAP queue 1, item 9f (training rwkv6)"


def no_autograd(name, *xs):
    """The WKV recurrence has no backward kernel yet: refuse a call that
    autograd would record."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in xs):
        raise NotImplementedError(
            f"{name} has no backward: gradients through it come with "
            f"{TRAINING_ITEM}")


def _t(x):
    return x.transpose(1, 2)


def wkv(r, k, v, w, u, S0=None, *, executor: str = "auto"):
    """r, k, v, w [B, T, H, hd]; u [H, hd]; S0 [B, H, hd, hd] or None (the
    TPU kernel's zero start) -> (y [B, T, H, hd] in r's dtype, S_final
    [B, H, hd, hd] float32), by executor: ``auto`` is the kernel on a CUDA
    device and the plain version on the CPU; ``cuda`` is the kernel and
    raises for CPU tensors; ``reference`` is the plain version on any
    device (the card's comparison)."""
    check_executor(executor)
    no_autograd("the WKV recurrence", r, k, v, w, u, S0)
    if executor == "cuda" and r.device.type != "cuda":
        raise ValueError(f"executor='cuda' needs CUDA tensors, got "
                         f"{r.device}")
    fn = wkv_ref if executor == "reference" else wkv_bhtd
    y, S = fn(_t(r), _t(k), _t(v), _t(w), u, S0)
    return _t(y), S


def wkv_oracle(r, k, v, w, u):
    """The plain version in the model layout, from a zero state: y only (as
    JAX's ``wkv_oracle``)."""
    return _t(wkv_ref(_t(r), _t(k), _t(v), _t(w), u)[0])
