"""Plain PyTorch version of the flash-attention kernel (the port of
``repro/kernels/flash_attention/ref.py``): float32 math, GQA by repeat."""
from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  return_lse: bool = False, q_offset: int = 0):
    """q [B,H,Tq,hd], k/v [B,Hkv,Tk,hd] -> [B,H,Tq,hd] in q's dtype (and
    lse [B,H,Tq] float32 when ``return_lse``).

    Query row i sits at position ``q_offset + i`` and key j at j (the
    kernel's positions, with ``q_offset`` 0).  ``q_offset`` lets a caller
    check a slice of the rows of a long sequence without its full score
    matrix."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.zeros((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask |= kpos > qpos
    if window > 0:
        mask |= kpos <= qpos - window
    s = s.masked_fill(mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o
