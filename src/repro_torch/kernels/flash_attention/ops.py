"""Public wrapper: model layout [B,T,H,hd] over the kernels' [B,H,T,hd]
(the port of ``repro/kernels/flash_attention/ops.py``).  The layouts differ
only by a ``transpose`` view: the kernels take strides, so nothing is
copied.

Under autograd, :func:`flash_attention` runs :class:`FlashAttention`, the
counterpart of JAX's ``flash_attention_trainable`` (ops.py:48-80): the
forward kernel with its LSE, then the backward kernel from the saved
output and LSE.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhtd, kernel_layout_ok
from .flash_attention_bwd import flash_attention_bwd_bhtd
from .ref import attention_bwd_ref, attention_ref

EXECUTORS = ("auto", "cuda", "reference")

#: The JAX kernel's K block.  Its wrapper refuses non-causal attention over
#: a partial last block (that kernel leaves the block's tail unmasked), and
#: this one keeps the contract.
BK = 128


def check_executor(executor: str):
    if executor not in EXECUTORS:
        raise ValueError(f"unknown attention executor {executor!r}; have "
                         f"{EXECUTORS}")


def _t(x):
    return x.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention in the model layout: forward and backward
    both run the kernels (the plain versions when ``reference`` is set, or
    for CPU tensors).  Saves q, k, v, o (kernel layout) and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, reference, q_offset=0):
        fwd = attention_ref if reference else flash_attention_bhtd
        o, lse = fwd(_t(q), _t(k), _t(v), causal=causal, window=window,
                     return_lse=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.reference = causal, window, reference
        ctx.q_offset = q_offset
        return _t(o)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        do = _t(g)
        if not ctx.reference and not kernel_layout_ok(do):
            do = _t(g.contiguous())
        bwd = attention_bwd_ref if ctx.reference else flash_attention_bwd_bhtd
        dq, dk, dv = bwd(_t(q), _t(k), _t(v), o, lse, do, causal=ctx.causal,
                         window=ctx.window, q_offset=ctx.q_offset)
        return _t(dq), _t(dk), _t(dv), None, None, None, None


def gqa_kv(k, v, n_q: int, heads):
    """k/v [B,Tk,n,hd] arranged for ``n_q`` query heads of a model's
    ``heads = (q_head0, kv_head0, group)``: the query heads are the model's
    q_head0.., k/v hold its key-value heads kv_head0.., and query head h
    attends with key-value head h // group.  Returns the key-value heads
    those query heads use, a slice where they take them in equal groups
    (the kernels' GQA), else one per query head (a gather, whose
    gradient adds each group's parts)."""
    q0, k0, g = heads
    idx = [(q0 + i) // g - k0 for i in range(n_q)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if n_q % n == 0 and idx == [lo + i // (n_q // n) for i in range(n_q)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    sel = torch.as_tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    executor: str = "auto", heads=None, q_offset: int = 0):
    """q [B,Tq,H,hd], k/v [B,Tk,Hkv,hd] -> [B,Tq,H,hd], by executor:
    ``auto`` is the kernel on a CUDA device and the plain version on the
    CPU; ``cuda`` is the kernel and raises for CPU tensors; ``reference`` is
    the plain version on any device (the card's comparison).  When grad is
    enabled and an input requires it, the call goes through
    :class:`FlashAttention`, whose backward follows the same executor.
    ``heads`` (a rank's share of a model's heads, :func:`gqa_kv`): q and
    k/v hold some of the model's heads, and k/v are cut to those q uses.
    ``q_offset``: the position of q's first row, keys from 0 (a rank's
    block of the queries against every key, context-parallel attention).

    Non-causal attention requires Tk % BK == 0 (or Tk <= BK)."""
    check_executor(executor)
    if heads is not None:
        k, v = gqa_kv(k, v, q.shape[2], heads)
    if not causal and k.shape[1] % min(BK, k.shape[1]) != 0:
        raise ValueError(
            f"non-causal flash attention needs Tk divisible by bk "
            f"(Tk={k.shape[1]}, bk={BK}); pad K/V")
    if executor == "cuda" and q.device.type not in ("cuda", "meta"):
        raise ValueError(f"executor='cuda' needs CUDA tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window,
                                    executor == "reference", q_offset)
    if executor == "reference":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return _t(flash_attention_bhtd(_t(q), _t(k), _t(v), causal=causal,
                                   window=window, q_offset=q_offset))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    return _t(attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            window=window, q_offset=q_offset))
