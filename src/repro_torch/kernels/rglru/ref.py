"""Plain PyTorch versions of the RG-LRU scan kernel and of its backward
(the port of ``repro/kernels/rglru/ref.py``; the backward is the port's
own).  Both compute in float32 (float64 for float64 inputs, which
``torch.autograd.gradcheck`` takes)."""
from __future__ import annotations

import torch


def _wide(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rglru_ref(a, b):
    """a, b [B, T, C] -> h [B, T, C] in a's dtype, ``h_t = a_t * h_{t-1} +
    b_t`` from a zero carry: the sequential recurrence in float32, a product
    rounded before the add, in the TPU kernel's order (rglru.py:35-41).
    JAX's oracle runs ``lax.associative_scan``, whose tree rounds
    differently; the CUDA kernel equals this loop bit for bit."""
    af, bf = _wide(a), _wide(b)
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rglru_bwd_ref(a, h, g):
    """The gradients (da, db) [B, T, C], float32, of ``h = rglru_ref(a, b)``
    for the output gradient ``g``, from the forward's ``h``: the reverse
    recurrence ``lam_t = a_{t+1} * lam_{t+1} + g_t`` from zero, each
    product rounded before the add, then ``db_t = lam_t`` and ``da_t =
    lam_t * h_{t-1}`` (``h_{-1} = 0``), in the kernel's order
    (csrc/rglru.cu, ``rglru_bwd_kernel``): the CUDA kernel equals this loop
    bit for bit."""
    af, hf, gf = _wide(a), _wide(h), _wide(g)
    lam = torch.zeros_like(af[:, 0])
    a_next = torch.zeros_like(lam)
    da, db = torch.empty_like(af), torch.empty_like(af)
    for t in range(a.shape[1] - 1, -1, -1):
        lam = a_next * lam + gf[:, t]
        db[:, t] = lam
        da[:, t] = lam * (hf[:, t - 1] if t > 0 else 0.0)
        a_next = af[:, t]
    return da, db
