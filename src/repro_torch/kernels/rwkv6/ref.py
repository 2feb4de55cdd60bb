"""Plain PyTorch version of the WKV kernel (the port of
``repro/kernels/rwkv6/ref.py`` and of ``repro/models/rwkv6.py::
wkv_scan_with_state``): a Python loop over time in float32."""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, S0=None):
    """r, k, v, w [B, H, T, hd]; u [H, hd]; S0 [B, H, hd, hd] or None
    (zeros) -> (y [B, H, T, hd] in r's dtype, S_final [B, H, hd, hd]
    float32).

    Each step in the order of the JAX model's scan (rwkv6.py:221-227): the
    output reads the old state, then the state decays and takes the outer
    product ``k_t^T v_t``."""
    B, H, T, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        att = torch.einsum("bhi,bhij->bhj", rt, S)
        bonus = torch.einsum("bhi,bhi->bh", rt, uf[None] * kt)
        ys.append(att + bonus[..., None] * vt)
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, dim=2).to(r.dtype), S
