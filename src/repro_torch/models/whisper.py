"""Whisper-small backbone (arXiv:2212.04356), an encoder-decoder
transformer (the port of ``repro/models/whisper.py``).

The conv1d audio frontend is a stub, as in the JAX package: the caller
passes pre-computed frame embeddings [B, frames, d_model].  Positions are
sinusoidal in both stacks (upstream whisper's decoder has a learned table
capped at 448 positions; JAX's package uses the sinusoidal form so that
decode positions are unbounded).

Parameters keep JAX's tree: ``embed`` [padded vocab, D], ``enc_layers`` and
``dec_layers`` as lists of per-layer dicts, ``enc_norm``, ``dec_norm``.
The encoder's self-attention and the decoder's cross-attention are
non-causal full scores (JAX's ``attention_scores_full``; the encoder's
1,500 frames are not a multiple of the flash kernel's 128-key block); the
decoder's causal self-attention runs the flash attention kernel in a
prefill into empty caches.  Decode caches are a list of per-layer KV caches
(:func:`init_caches`).  Under grad with ``cfg.remat``, each layer runs
under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``,
whisper.py:87-88, :117-118).

In a partitioned train step (``distributed.sharding.partitioned``) the
attention and the MLP of both stacks are ``layers``' regions on the
rank's blocks.  Each stack's residual stream is the rank's block of its
sequence where ``layers.sequence_parallel`` holds (JAX's
``residual_shard``: the frames, the tokens), whole elsewhere.  The
encoder's output enters the decoder's regions once, for all its layers:
gathered over T by ``gather_from_sequence`` (whose reduce-scatter sums
the ranks' partial gradients, each its heads' or query block's) where
the encoder ran sequence-parallel, else by ``copy_to_model`` (the same
sum); the cross-attention takes it as it is, so its gradient is summed
once.  The tied, padded vocabulary is cut by rows through
``lm.embed`` and ``lm.logits_of``, the padding's -1e30 on the rank's
block of the logits by global column index.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (copy_to_model, gather_from_sequence,
                                    model_axis, sequence_block)
from . import layers as L
from . import lm
from .common import ModelConfig
from .lm import _cut_tree, _to


def padded_vocab(cfg: ModelConfig, multiple: int = 16) -> int:
    """The vocab rounded up to ``multiple`` (whisper's 51,865 -> 51,872;
    JAX pads it so the embedding shards over a mesh).  The padding's logits
    are masked to -1e30."""
    return ((cfg.vocab_size + multiple - 1) // multiple) * multiple


def sinusoidal(positions, d_model: int):
    """positions [B, T] -> [B, T, D] float32 sinusoidal embeddings."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_enc_layer(cfg: ModelConfig, gen):
    return {"ln1": L.init_norm(cfg, cfg.d_model),
            "attn": L.init_attention(cfg, gen),
            "ln2": L.init_norm(cfg, cfg.d_model),
            "mlp": L.init_mlp(cfg, gen)}


def init_dec_layer(cfg: ModelConfig, gen):
    return {"ln1": L.init_norm(cfg, cfg.d_model),
            "self_attn": L.init_attention(cfg, gen),
            "ln_x": L.init_norm(cfg, cfg.d_model),
            "cross_attn": L.init_attention(cfg, gen, cross=True),
            "ln2": L.init_norm(cfg, cfg.d_model),
            "mlp": L.init_mlp(cfg, gen)}


def init_params(cfg: ModelConfig, seed=0, *, device=None, cut=None):
    """Random parameters in JAX's tree and init scales from a
    ``torch.Generator`` (``seed`` an int, for a CPU generator, or a
    generator, whose device draws), on ``device`` (default: the CUDA card;
    raises without one; ``"meta"``: the shapes alone, nothing drawn).
    Draw order: embed, the encoder's layers, the
    decoder's.  ``cut(path, leaf, stacked)``: what of each leaf is kept
    as it is drawn (``lm.init_params``'s)."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    keep = cut or (lambda path, x, stacked: x)
    embed = keep(("embed",), L._normal(
        gen, (padded_vocab(cfg), cfg.d_model), 0.02, L._dtype(cfg)),
        False).to(dev)
    enc = [_to(_cut_tree(init_enc_layer(cfg, gen), ("enc_layers", i), keep),
               dev) for i in range(cfg.num_encoder_layers)]
    dec = [_to(_cut_tree(init_dec_layer(cfg, gen), ("dec_layers", i), keep),
               dev) for i in range(cfg.num_layers)]
    return {"embed": embed, "enc_layers": enc,
            "enc_norm": _to(L.init_norm(cfg, cfg.d_model), dev),
            "dec_layers": dec,
            "dec_norm": _to(L.init_norm(cfg, cfg.d_model), dev)}


def _remat(cfg):
    return cfg.remat and torch.is_grad_enabled()


def encode(cfg: ModelConfig, params, frame_embeds, seq=False):
    """frame_embeds [B, F, D] (the stub frontend's output) -> the encoder's
    output [B, F, D]: bidirectional self-attention, no rotary embedding.
    The frames plus their positions (in the frames' dtype, as JAX adds
    them) are brought to the model's dtype; JAX would instead promote a
    bf16 stream against float32 weights op by op.  ``seq``: in a
    partitioned step, the stream and the output are the rank's block of
    the frames."""
    B, F, D = frame_embeds.shape
    t0, n = sequence_block(F, model_axis() if seq else None)
    pos = torch.arange(t0, t0 + n, device=frame_embeds.device)[None].expand(
        B, n)
    x = (frame_embeds[:, t0:t0 + n] + sinusoidal(pos, D).to(
        frame_embeds.dtype)).to(L._dtype(cfg))
    zero_pos = torch.zeros((B, F), dtype=torch.long,
                           device=frame_embeds.device)

    def enc_layer(p, x):
        hn = L.apply_norm(cfg, p["ln1"], x, seq=seq)
        h, _ = L.attention(cfg, p["attn"], hn, zero_pos, causal=False,
                           xkv=hn, seq=seq)
        x = x + h
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x,
                                                     seq=seq), seq=seq)

    remat = _remat(cfg)
    context_fn = L.remat_policy(cfg) if remat else None
    for p in params["enc_layers"]:
        x = (checkpoint(enc_layer, p, x, use_reentrant=False,
                        context_fn=context_fn) if remat else enc_layer(p, x))
    return L.apply_norm(cfg, params["enc_norm"], x, seq=seq)


def decode(cfg: ModelConfig, params, tokens, enc_out, *, positions=None,
           caches=None, logits_slice=None, executor: str = "auto"):
    """The decoder stack.  ``caches``: the list of per-layer self-attention
    KV caches (written in place; the returned list replaces it) or None.
    ``enc_out`` is brought to the model's dtype (for a float32 model, the
    exact upcast of JAX's promotion of bf16 frames); in a partitioned
    step it is already inside the regions (module docstring).
    Returns (logits [B, T, padded vocab], new_caches): in a partitioned
    step the rank's block of the vocabulary where it holds one."""
    B, T = tokens.shape
    ax = model_axis()
    enc_out = enc_out.to(L._dtype(cfg))
    from_start = positions is None
    if positions is None:
        positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    seq = (caches is None and logits_slice is None
           and L.sequence_parallel(cfg, ax, T))
    pv = padded_vocab(cfg)
    t0, n = sequence_block(T, ax if seq else None)
    x = lm.embed(cfg, params, tokens, seq, vocab=pv) + sinusoidal(
        positions[:, t0:t0 + n], cfg.d_model).to(params["embed"].dtype)

    def dec_layer(p, x, cache):
        h, c2 = L.attention(cfg, p["self_attn"],
                            L.apply_norm(cfg, p["ln1"], x, seq=seq),
                            positions, causal=True, cache=cache,
                            from_start=from_start, executor=executor,
                            seq=seq)
        x = x + h
        h, _ = L.attention(cfg, p["cross_attn"],
                           L.apply_norm(cfg, p["ln_x"], x, seq=seq),
                           positions, causal=False, xkv=enc_out, seq=seq)
        x = x + h
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x,
                                                     seq=seq), seq=seq), c2

    remat = caches is None and _remat(cfg)
    context_fn = L.remat_policy(cfg) if remat else None
    new_caches = [] if caches is not None else None
    for i, p in enumerate(params["dec_layers"]):
        if remat:
            x, _ = checkpoint(dec_layer, p, x, None, use_reentrant=False,
                              context_fn=context_fn)
            continue
        x, c2 = dec_layer(p, x, caches[i] if caches is not None else None)
        if caches is not None:
            new_caches.append(c2)

    x = L.apply_norm(cfg, params["dec_norm"], x, seq=seq)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = lm.logits_of(cfg, params, x, seq, vocab=pv)
    if pv != cfg.vocab_size:   # mask the vocab-padding slots
        # by global column: the rank's block starts at rank x its width
        c0 = 0 if logits.shape[-1] == pv else ax.rank * logits.shape[-1]
        pad = torch.arange(c0, c0 + logits.shape[-1],
                           device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits, new_caches


def forward(cfg: ModelConfig, params, tokens, *, frame_embeds=None,
            positions=None, caches=None, enc_out=None, logits_slice=None,
            executor: str = "auto", **_):
    """Teacher-forced encoder-decoder forward.  For decode steps pass
    ``enc_out`` (from :func:`encode`, computed once) and ``caches``; else
    ``frame_embeds`` is encoded first.  Other keywords (``moe_impl``,
    ``mrope_pos``, ...) are ignored, as JAX's forward ignores them.
    Returns (logits, new_caches, aux = 0)."""
    if enc_out is None and frame_embeds is None:
        raise ValueError("whisper needs frame_embeds, or enc_out from "
                         "encode()")
    ax = model_axis()
    with torch.no_grad() if caches is not None else \
            contextlib.nullcontext():
        if enc_out is None:
            seq = L.sequence_parallel(cfg, ax, frame_embeds.shape[1])
            enc_out = encode(cfg, params, frame_embeds, seq)
            # into the decoder's regions once (module docstring)
            enc_out = (gather_from_sequence(enc_out, ax) if seq
                       else copy_to_model(enc_out, ax))
        logits, new_caches = decode(cfg, params, tokens, enc_out,
                                    positions=positions, caches=caches,
                                    logits_slice=logits_slice,
                                    executor=executor)
    return logits, new_caches, torch.zeros((), dtype=torch.float32,
                                           device=logits.device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device=None):
    """One self-attention KV cache per decoder layer (bf16 by default, as
    JAX); each write offset ``idx`` is a host int."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    return [L.init_cache(cfg, batch, max_len, dtype, device=dev)
            for _ in range(cfg.num_layers)]
