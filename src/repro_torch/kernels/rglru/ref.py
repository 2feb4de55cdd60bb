"""Plain PyTorch version of the RG-LRU scan kernel (the port of
``repro/kernels/rglru/ref.py``)."""
from __future__ import annotations

import torch


def rglru_ref(a, b):
    """a, b [B, T, C] -> h [B, T, C] in a's dtype, ``h_t = a_t * h_{t-1} +
    b_t`` from a zero carry: the sequential recurrence in float32, a product
    rounded before the add, in the TPU kernel's order (rglru.py:35-41).
    JAX's oracle runs ``lax.associative_scan``, whose tree rounds
    differently; the CUDA kernel equals this loop bit for bit."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)
