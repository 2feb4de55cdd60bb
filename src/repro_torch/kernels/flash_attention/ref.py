"""Plain PyTorch versions of the flash-attention kernels (the port of
``repro/kernels/flash_attention/ref.py``): float32 math on whole matrices,
GQA by repeat.  :func:`attention_ref` is the forward kernel's,
:func:`attention_bwd_ref` the backward kernel's."""
from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def _mask(Tq, Tk, causal, window, device, q_offset=0):
    """[Tq, Tk] True where key j is hidden from query row i (at position
    ``q_offset + i``)."""
    qpos = torch.arange(Tq, device=device)[:, None] + q_offset
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.zeros((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask |= kpos > qpos
    if window > 0:
        mask |= kpos <= qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  return_lse: bool = False, q_offset: int = 0):
    """q [B,H,Tq,hd], k/v [B,Hkv,Tk,hd] -> [B,H,Tq,hd] in q's dtype (and
    lse [B,H,Tq] float32 when ``return_lse``).

    Query row i sits at position ``q_offset + i`` and key j at j, as in
    the kernels (and JAX's ``attention_chunked(q_offset=...)``): a block
    of the queries of a longer sequence against all of its keys, as
    context-parallel attention runs it, or a slice of the rows checked
    without the full score matrix."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    s = s.masked_fill(_mask(Tq, Tk, causal, window, q.device, q_offset),
                      NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, q_offset: int = 0):
    """The backward from the forward's saved ``lse`` (the formulas of
    ``repro/kernels/flash_attention/flash_attention_bwd.py:8-10``) on whole
    matrices in float32: with s = q.k^T / sqrt(hd) masked, p = exp(s - lse),
    delta = rowsum(dO o o), ds = p o (dO.v^T - delta) / sqrt(hd),
    dq = ds.k, dk = ds^T.q and dv = p^T.dO.

    q, o, do [B,H,Tq,hd]; k/v [B,Hkv,Tk,hd]; lse [B,H,Tq] float32.  Returns
    (dq [B,H,Tq,hd], dk, dv [B,Hkv,Tk,hd]) in the inputs' dtypes, dk and dv
    summed over each key/value head's group of query heads.  Query row i
    sits at position ``q_offset + i`` (:func:`attention_ref`)."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k.float(), rep, dim=1)
    vf = torch.repeat_interleave(v.float(), rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _mask(Tq, Tk, causal, window, q.device, q_offset)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(mask, 0.0)
    delta = (dof * o.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, rep, Tk, hd).sum(2)
    dv = dv.reshape(B, Hkv, rep, Tk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
