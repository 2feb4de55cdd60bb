"""Decoder-only LM of the dense family (the port of ``repro/models/lm.py``):
qwen2-0.5b, qwen3-0.6b, olmo-1b, yi-9b.

Parameters keep JAX's tree: ``embed`` [V, D], ``blocks`` with every leaf
stacked over layers [L, ...], ``final_norm`` (and ``head`` when the
embeddings are untied).  A Python loop over layers takes the place of
``lax.scan``.  The forward without a cache builds an autograd graph when
grad is enabled (training); with ``cfg.remat`` each block then runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``, lm.py:96-97), so the
backward recomputes it.  The cached paths (prefill and decode) run without
grad.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .common import ModelConfig


def _unstack(tree, n):
    """A tree of stacked [n, ...] leaves -> n per-layer trees, by one
    ``unbind(0)`` per leaf (whose backward stacks the layers' gradients
    into one [n, ...] tensor; ``v[i]`` per layer would add a full zero
    gradient per layer)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def init_block(cfg: ModelConfig, gen):
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks come with the MoE slice "
                                  "(ROADMAP queue 1, item 9e)")
    return {
        "ln1": L.init_norm(cfg, cfg.d_model),
        "attn": L.init_attention(cfg, gen),
        "ln2": L.init_norm(cfg, cfg.d_model),
        "mlp": L.init_mlp(cfg, gen),
    }


def block_fwd(cfg: ModelConfig, p, x, positions, cache, *, from_start,
              executor):
    h, new_cache = L.attention(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), positions,
        causal=True, window=cfg.sliding_window, cache=cache,
        from_start=from_start, executor=executor)
    x = x + h
    hn = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp(cfg, p["mlp"], hn), new_cache


def init_params(cfg: ModelConfig, seed=0, *, device=None):
    """Random parameters in JAX's tree and init scales, drawn from a
    ``torch.Generator`` (``seed`` is an int, for a CPU generator, or a
    generator, whose device draws), then moved to ``device`` (default: the
    CUDA card; raises without one)."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    dt = L._dtype(cfg)
    params = {"embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                 dt),
              "blocks": _stack([init_block(cfg, gen)
                                for _ in range(cfg.num_layers)]),
              "final_norm": L.init_norm(cfg, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                   dt)
    return _to(params, dev)


def forward(cfg: ModelConfig, params, tokens, *, positions=None,
            caches=None, logits_slice: Optional[int] = None,
            executor: str = "auto"):
    """Run the LM.

    tokens     [B, T] integer
    positions  [B, T] (defaults to 0..T-1; decode passes cache offsets)
    caches     stacked layer KV caches (:func:`init_caches`) or None; they
               are written in place and the returned dict replaces them
               (always without grad)
    logits_slice  compute logits of the last ``logits_slice`` positions only
    executor   the flash-attention sites' implementation (``auto``:
               the kernel on a card, the plain version on the CPU)
    Returns (logits [B, T, V], new_caches, aux_loss).
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"the port's LM serves the dense family; "
                                  f"{cfg.family!r} comes with its slice")
    with torch.no_grad() if caches is not None else \
            contextlib.nullcontext():
        return _forward(cfg, params, tokens, positions, caches, logits_slice,
                        executor)


def _forward(cfg, params, tokens, positions, caches, logits_slice, executor):
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    from_start = positions is None
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    context_fn = L.remat_policy(cfg) if remat else None
    for i, bp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        if remat:
            x, _ = checkpoint(block_fwd, cfg, bp, x, positions, None,
                              from_start=from_start, executor=executor,
                              use_reentrant=False, context_fn=context_fn)
            continue
        c = None
        if caches is not None:
            c = dict(caches, k=caches["k"][i], v=caches["v"][i])
        x, _ = block_fwd(cfg, bp, x, positions, c, from_start=from_start,
                         executor=executor)

    x = L.apply_norm(cfg, params["final_norm"], x)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = x @ params["head"]
    new_caches = None
    if caches is not None:
        new_caches = {k: v for k, v in caches.items() if k != "rows"}
        new_caches["idx"] = caches["idx"] + T
    return logits, new_caches, torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, per_row: bool = False, *, device=None):
    """Stacked [L, ...] KV caches for decode (bf16 by default, also under a
    float32 model, as JAX).  ``per_row``: continuous-batching caches where
    each batch slot writes at its own position.  The write offset ``idx``
    is a host int."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "idx": 0, "per_row": per_row}
