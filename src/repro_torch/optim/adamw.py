"""AdamW + gradient clipping + the warmup-cosine LR schedule (the port of
``repro/optim/adamw.py``) on dict trees of tensors.

Every float32 operation is JAX's, in JAX's order: Python constants enter as
float32, divisions are tensor by tensor (a Python float over a tensor, or a
tensor over a CPU scalar on CUDA, would multiply by a reciprocal), the bias
corrections ``1 - b ** count`` are float32 powers, and the global norm sums
the leaves' squared norms in ``jax.tree`` order (sorted keys).  Per-leaf
reductions run in PyTorch's order, not XLA's, and ``cos`` / ``pow`` are
another library's, so results agree with JAX to about an ulp, not bit for
bit.  Weight decay follows JAX exactly: it skips leaves with ``ndim < 2``,
so the stacked [L, D] norm scales of the blocks *are* decayed and
``final_norm`` is not (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor          # int32 scalar on the parameters' device


def _f32(x, like):
    """A float32 scalar tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw_init(params) -> OptState:
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


def warmup_cosine(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an integer scalar tensor)."""
    step = step.to(torch.float32)
    warm = torch.minimum(torch.div(step, _f32(max(cfg.warmup_steps, 1),
                                              step)), _f32(1.0, step))
    prog = torch.clamp(torch.div(
        step - cfg.warmup_steps,
        _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, cut=None, group=None):
    """The float32 norm of every leaf of ``tree`` together, the squares
    summed in leaf order.  Over the blocks of a partitioned step: ``cut``
    (one flag a leaf, in leaf order) marks the leaves of which each rank
    of ``group`` holds a block; their squares are summed over the group
    (one all-reduce), and a replicated leaf counts once."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)]
    if cut is not None and any(cut):
        import torch.distributed as dist

        part = torch.stack([s if c else torch.zeros_like(s)
                            for s, c in zip(sq, cut)])
        dist.all_reduce(part, group=group)
        sq = [part[i] if c else s for i, (s, c) in enumerate(zip(sq, cut))]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm, gn=None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm (``gn``, where the caller has it: a partitioned step's, taken
    over its blocks)."""
    gn = global_norm(grads) if gn is None else gn
    scale = torch.minimum(_f32(1.0, gn), torch.div(
        _f32(max_norm, gn), torch.clamp_min(gn, 1e-9)))
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(cfg: AdamWConfig, grads, state: OptState, params,
                 grad_norm=None):
    """Returns (new_params, new_state, metrics); nothing is updated in
    place.  Elementwise but for the clip, so a partitioned step updates
    its blocks (or its data shares of them) with ``grad_norm``, the norm
    of the whole gradient (:func:`global_norm` over the blocks)."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    count = state.count + 1
    lr = warmup_cosine(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** count.to(torch.float32)
    bc2 = 1.0 - b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        gf = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * torch.square(gf)
        mhat = torch.div(m2, bc1)
        vhat = torch.div(v2, bc2)
        step = torch.div(mhat, torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay (skip 1-D params: norms, biases, mus)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * step
        return p2.to(p.dtype), m2, v2

    out = tree_map(upd, grads, state.mu, state.nu, params)
    return _pick(out, 0), OptState(_pick(out, 1), _pick(out, 2), count), {
        "grad_norm": gn, "lr": lr}


def _pick(tree, i):
    """Element ``i`` of each (p, m, v) leaf triple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
