"""Plain PyTorch versions of the WKV kernel (the port of
``repro/kernels/rwkv6/ref.py`` and of ``repro/models/rwkv6.py::
wkv_scan_with_state``) and of its backward (the port's own: JAX
differentiates its ``lax.scan``): Python loops over time in float32
(float64 for float64 inputs, which ``torch.autograd.gradcheck`` takes)."""
from __future__ import annotations

import torch


def _wide(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def wkv_ref(r, k, v, w, u, S0=None):
    """r, k, v, w [B, H, T, hd]; u [H, hd]; S0 [B, H, hd, hd] or None
    (zeros) -> (y [B, H, T, hd] in r's dtype, S_final [B, H, hd, hd]
    float32, or float64 for float64 inputs).

    Each step in the order of the JAX model's scan (rwkv6.py:221-227): the
    output reads the old state, then the state decays and takes the outer
    product ``k_t^T v_t``."""
    B, H, T, hd = r.shape
    rf, kf, vf, wf, uf = (_wide(x) for x in (r, k, v, w, u))
    S = (torch.zeros((B, H, hd, hd), dtype=rf.dtype, device=r.device)
         if S0 is None else S0.to(rf.dtype))
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        att = torch.einsum("bhi,bhij->bhj", rt, S)
        bonus = torch.einsum("bhi,bhi->bh", rt, uf[None] * kt)
        ys.append(att + bonus[..., None] * vt)
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, dim=2).to(r.dtype), S


def wkv_bwd_ref(r, k, v, w, u, S0, dy, dS_final=None):
    """The gradients of :func:`wkv_ref` for the output gradients ``dy``
    [B, H, T, hd] and ``dS_final`` [B, H, hd, hd] (None: zeros) -> (dr, dk,
    dv in r's dtype, dw in w's dtype, du [H, hd] and dS0 [B, H, hd, hd]
    float32; float64 for float64 inputs).

    The states S_t (before step t) come from a forward walk kept whole;
    then t walks down from T - 1 carrying dS = dS_{t+1}, with c_t = dy_t .
    v_t:
        dr_t = dy_t S_t^T + c_t (u o k_t)
        dk_t = dS v_t + c_t (u o r_t)
        dv_t = k_t dS + (r_t . (u o k_t)) dy_t
        dw_t = rowsum(dS o S_t)
        dS  <- diag(w_t) dS + r_t^T dy_t
        du  += c_t (r_t o k_t), summed over b and t,
    and dS ends as dS0."""
    B, H, T, hd = r.shape
    rf, kf, vf, wf, uf, gf = (_wide(x) for x in (r, k, v, w, u, dy))
    S = (torch.zeros((B, H, hd, hd), dtype=rf.dtype, device=r.device)
         if S0 is None else S0.to(rf.dtype))
    states = []
    for t in range(T):
        states.append(S)
        S = wf[:, :, t, :, None] * S + kf[:, :, t, :, None] * \
            vf[:, :, t, None, :]
    dS = (torch.zeros_like(S) if dS_final is None
          else dS_final.to(rf.dtype))
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=rf.dtype, device=r.device)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, wt, gt = (x[:, :, t] for x in (rf, kf, vf, wf, gf))
        St = states[t]
        c = (gt * vt).sum(-1, keepdim=True)
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhj,bhij->bhi", gt, St) + c * uf * kt
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", dS, vt) + c * uf * rt
        dv[:, :, t] = torch.einsum("bhi,bhij->bhj", kt, dS) + bonus * gt
        dw[:, :, t] = (dS * St).sum(-1)
        du += c * rt * kt
        dS = wt[..., None] * dS + rt[..., None] * gt[..., None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du.sum(0), dS)
