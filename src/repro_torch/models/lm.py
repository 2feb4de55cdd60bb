"""Decoder-only LM (the port of ``repro/models/lm.py``): the dense family
(qwen2-0.5b, qwen3-0.6b, olmo-1b, yi-9b), the MoE family
(qwen3-moe-30b-a3b, moonshot-v1-16b-a3b) and the VLM family's text backbone
(qwen2-vl-2b: M-RoPE; patch embeddings arrive pre-computed through
``vision_embeds``).  Its :func:`embed` and :func:`logits_of` are every
family's vocabulary, cut or whole in a partitioned step (rwkv6's,
recurrentgemma's and whisper's too).

Parameters keep JAX's tree: ``embed`` [V, D], ``blocks`` with every leaf
stacked over layers [L, ...], ``final_norm`` (and ``head`` when the
embeddings are untied).  A Python loop over layers takes the place of
``lax.scan``.  The forward without a cache builds an autograd graph when
grad is enabled (training); with ``cfg.remat`` each block then runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``, lm.py:96-97), so the
backward recomputes it.  The cached paths (prefill and decode) run without
grad.

In a partitioned train step (``distributed.sharding.partitioned``) the
vocabulary is cut over the model axis where the specs cut ``embed`` (and
``head``): the lookup zeroes the rows outside the rank's range and sums
over the axis, and the logits are the rank's block of the vocabulary
(JAX's ``logits_shard``), for ``train.step.cross_entropy`` to reduce.
Where ``layers.sequence_parallel`` holds (JAX's ``residual_shard``,
lm.py:40-41: ``cfg.seq_parallel``, no cache, the model axis dividing T),
the residual stream is the rank's [B, T / model, D] block from the
embedding (whose sum over the axis is reduce-scattered) through every
block and the final norm; the logits gather T first, so they stay whole
in T and cut by vocabulary.  Elsewhere the stream is whole on every rank.
The VLM's ``vision_embeds`` replace the first Tv slots of the sequence,
of the rank's block under sequence parallelism; its M-RoPE positions
reach context-parallel attention as the query block's.  The lookup's
gradient is the rank's rows (cut only); the logits' input, gathered over
T into the region, has its partial gradients summed.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (copy_to_model, gather_from_sequence,
                                    gather_out_of_model, model_axis,
                                    reduce_from_model, scatter_to_sequence,
                                    sequence_block)
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


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


#: The MoE implementations of the forward (JAX's ``moe_impl``); ``a2a`` is
#: expert parallelism over the ambient mesh's 'model' axis
#: (``distributed/moe_a2a.py``; ``gmm`` without a mesh).
MOE_IMPLS = ("gmm", "dense", "a2a")


def init_block(cfg: ModelConfig, gen):
    p = {
        "ln1": L.init_norm(cfg, cfg.d_model),
        "attn": L.init_attention(cfg, gen),
        "ln2": L.init_norm(cfg, cfg.d_model),
    }
    if cfg.moe is not None:
        p["moe"] = L.init_moe(cfg, gen)
    else:
        p["mlp"] = L.init_mlp(cfg, gen)
    return p


def block_fwd(cfg: ModelConfig, p, x, positions, cache, mrope_pos, *,
              moe_impl, from_start, executor, seq=False):
    """One block: (x, new cache, aux loss).  ``seq``: x is the rank's
    block of the sequence-parallel stream (module docstring)."""
    h, new_cache = L.attention(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x, seq=seq), positions,
        causal=True, window=cfg.sliding_window, cache=cache,
        from_start=from_start, mrope_pos=mrope_pos, executor=executor,
        seq=seq)
    x = x + h
    hn = L.apply_norm(cfg, p["ln2"], x, seq=seq)
    if cfg.moe is not None:
        if moe_impl == "a2a":
            from ..distributed.moe_a2a import moe_a2a
            h, aux = moe_a2a(cfg, p["moe"], hn, seq=seq)
        else:
            fn = L.moe_gmm if moe_impl == "gmm" else L.moe_dense
            h, aux = fn(cfg, p["moe"], hn, seq=seq)
    else:
        h = L.mlp(cfg, p["mlp"], hn, seq=seq)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, new_cache, aux


def check_moe_impl(cfg: ModelConfig, moe_impl: str):
    """Refuses an unknown ``moe_impl``."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {moe_impl!r}; have {MOE_IMPLS}")


def _cut_tree(tree, path, keep):
    """``keep(path, leaf, False)`` over the leaves of a tree of dicts (a
    layer drawn whole: what an ``init_params``' ``cut`` keeps of it)."""
    return {k: _cut_tree(v, path + (k,), keep) if isinstance(v, dict)
            else keep(path + (k,), v, False) for k, v in tree.items()}


def _stacked(n, make, dev, cut=None):
    """``n`` layer trees from ``make()`` (called n times in a row, so the
    draws are those of n calls), every leaf stacked [n, ...] on ``dev``:
    each stacked leaf is allocated once and filled layer by layer, so the
    peak is the stack and one layer (stacking n drawn layers would hold the
    weights twice: 2 x 60.4 GB at qwen3-moe-30b-a3b's size).  ``cut(path,
    layer leaf)``: what of each layer's leaf is kept (a rank's block)."""
    cut = cut or (lambda path, x: x)

    def alloc(node, path=()):
        return {k: alloc(v, path + (k,)) if isinstance(v, dict) else
                torch.empty((n,) + cut(path + (k,), v).shape,
                            dtype=v.dtype, device=dev)
                for k, v in node.items()}

    def fill(dst, src, i, path=()):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i, path + (k,))
            else:
                dst[k][i].copy_(cut(path + (k,), v))
    blocks = None
    for i in range(n):
        layer = make()
        blocks = blocks or alloc(layer)
        fill(blocks, layer, i)
        del layer
    return blocks


def init_params(cfg: ModelConfig, seed=0, *, device=None, cut=None):
    """Random parameters in JAX's tree and init scales, drawn from a
    ``torch.Generator`` (``seed`` is an int, for a CPU generator, or a
    generator, whose device draws), on ``device`` (default: the CUDA card;
    raises without one; ``"meta"``: the shapes alone, nothing drawn).
    Draw order: embed, then block by block
    (attention, then MLP or MoE), then head.  ``cut(path, leaf, stacked)``
    keeps a part of each leaf as it is drawn (a rank's block:
    ``train.step.init_train_state`` with a mesh), a stacked one layer by
    layer (``stacked`` True, the layer's leaf without its L axis), so the
    whole tree never exists; the draws are the same."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    dt = L._dtype(cfg)
    keep = cut or (lambda path, x, stacked: x)
    params = {"embed": keep(("embed",), L._normal(
                  gen, (cfg.vocab_size, cfg.d_model), 0.02, dt).to(dev),
                  False),
              "blocks": _stacked(cfg.num_layers,
                                 lambda: init_block(cfg, gen), dev,
                                 lambda path, x: keep(("blocks",) + path, x,
                                                      True)),
              "final_norm": L.init_norm(cfg, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["head"] = keep(("head",), L._normal(
            gen, (cfg.d_model, cfg.vocab_size), 0.02, dt), False)
    return _to(params, dev)


def embed(cfg: ModelConfig, params, tokens, seq=False, vocab=None):
    """The token embeddings [B, T, D]; in a partitioned step whose rank
    holds a block of the vocabulary's rows, the rank's rows looked up (the
    others zero) and summed over the model axis.  ``seq``: the rank's
    block [B, T / model, D] of the sum (a reduce-scatter), or of a whole
    table's lookup (the table entering the region).  ``vocab``: the
    table's rows whole (default ``cfg.vocab_size``; whisper's padded)."""
    e, ax = params["embed"], model_axis()
    if ax is None or e.shape[0] == (vocab or cfg.vocab_size):
        if not seq:
            return e[tokens.long()]
        t0, n = sequence_block(tokens.shape[1], ax)
        return copy_to_model(e, ax)[tokens[:, t0:t0 + n].long()]
    n = e.shape[0]
    t = tokens.long() - ax.rank * n
    inside = (t >= 0) & (t < n)
    x = e[t.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return scatter_to_sequence(x, ax) if seq else reduce_from_model(x, ax)


def logits_of(cfg: ModelConfig, params, x, seq=False, vocab=None):
    """x @ the output embedding (tied: ``embed``'s transpose); in a
    partitioned step, the rank's block of the vocabulary where it holds
    one.  ``seq``: x is the rank's sequence block, gathered over T first
    (into the region, or, for a whole vocabulary every rank computes
    alike, into the replicated stream).  ``vocab``: :func:`embed`'s."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    ax = model_axis()
    if ax is not None and w.shape[1] != (vocab or cfg.vocab_size):
        x = gather_from_sequence(x, ax) if seq else copy_to_model(x, ax)
    elif seq:
        x = gather_out_of_model(x, ax, 1)
    return x @ w.to(x.dtype)


def forward(cfg: ModelConfig, params, tokens, *, positions=None,
            caches=None, vision_embeds=None, mrope_pos=None,
            moe_impl: str = "gmm", logits_slice: Optional[int] = None,
            executor: str = "auto"):
    """Run the LM.

    tokens     [B, T] integer
    positions  [B, T] (defaults to 0..T-1; decode passes cache offsets)
    caches     stacked layer KV caches (:func:`init_caches`) or None; they
               are written in place and the returned dict replaces them
               (always without grad)
    vision_embeds  [B, Tv, D] pre-computed patch embeddings (VLM stub):
               they replace the embeddings of the first Tv token slots
    mrope_pos  [3, B, T] M-RoPE positions (t/h/w), used when ``cfg.mrope``
    moe_impl   ``gmm`` (:func:`layers.moe_gmm`), ``dense``
               (:func:`layers.moe_dense`) or ``a2a``
               (:func:`~repro_torch.distributed.moe_a2a.moe_a2a`)
    logits_slice  compute logits of the last ``logits_slice`` positions only
    executor   the flash-attention sites' implementation (``auto``:
               the kernel on a card, the plain version on the CPU)
    Returns (logits [B, T, V], new_caches, aux_loss summed over layers).
    """
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"lm.forward runs the dense, moe and vlm families, "
                         f"not {cfg.family!r}")
    check_moe_impl(cfg, moe_impl)
    with torch.no_grad() if caches is not None else \
            contextlib.nullcontext():
        return _forward(cfg, params, tokens, positions, caches,
                        vision_embeds, mrope_pos, moe_impl, logits_slice,
                        executor)


def _forward(cfg, params, tokens, positions, caches, vision_embeds,
             mrope_pos, moe_impl, logits_slice, executor):
    B, T = tokens.shape
    ax = model_axis()
    # the residual stream cut by sequence (JAX's residual_shard; a forward
    # without a cache, whose logits are all kept)
    seq = (caches is None and logits_slice is None
           and L.sequence_parallel(cfg, ax, T))
    x = embed(cfg, params, tokens, seq)
    if vision_embeds is not None:
        # they replace the first Tv token slots (of the rank's block)
        t0, n = sequence_block(T, ax if seq else None)
        m = max(0, min(vision_embeds.shape[1] - t0, n))
        x = torch.cat([vision_embeds[:, t0:t0 + m].to(x.dtype), x[:, m:]],
                      dim=1)
    from_start = positions is None
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    context_fn = L.remat_policy(cfg) if remat else None
    kw = dict(moe_impl=moe_impl, from_start=from_start, executor=executor,
              seq=seq)
    auxs = []
    for i, bp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        c = None
        if caches is not None:
            c = dict(caches, k=caches["k"][i], v=caches["v"][i])
        if remat:
            x, _, aux = checkpoint(block_fwd, cfg, bp, x, positions, None,
                                   mrope_pos, use_reentrant=False,
                                   context_fn=context_fn, **kw)
        else:
            x, _, aux = block_fwd(cfg, bp, x, positions, c, mrope_pos, **kw)
        auxs.append(aux)

    x = L.apply_norm(cfg, params["final_norm"], x, seq=seq)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = logits_of(cfg, params, x, seq)
    new_caches = None
    if caches is not None:
        new_caches = {k: v for k, v in caches.items() if k != "rows"}
        new_caches["idx"] = caches["idx"] + T
    return logits, new_caches, torch.stack(auxs).sum()


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
