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
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .common import ModelConfig
from .lm import _to


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


def init_params(cfg: ModelConfig, seed=0, *, device=None):
    """Random parameters in JAX's tree and init scales from a
    ``torch.Generator`` (``seed`` an int, for a CPU generator, or a
    generator, whose device draws), on ``device`` (default: the CUDA card;
    raises without one; ``"meta"``: the shapes alone, nothing drawn).
    Draw order: embed, the encoder's layers, the
    decoder's."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    embed = L._normal(gen, (padded_vocab(cfg), cfg.d_model), 0.02,
                      L._dtype(cfg)).to(dev)
    enc = [_to(init_enc_layer(cfg, gen), dev)
           for _ in range(cfg.num_encoder_layers)]
    dec = [_to(init_dec_layer(cfg, gen), dev) for _ in range(cfg.num_layers)]
    return {"embed": embed, "enc_layers": enc,
            "enc_norm": _to(L.init_norm(cfg, cfg.d_model), dev),
            "dec_layers": dec,
            "dec_norm": _to(L.init_norm(cfg, cfg.d_model), dev)}


def _remat(cfg):
    return cfg.remat and torch.is_grad_enabled()


def encode(cfg: ModelConfig, params, frame_embeds):
    """frame_embeds [B, F, D] (the stub frontend's output) -> the encoder's
    output [B, F, D]: bidirectional self-attention, no rotary embedding.
    The frames plus their positions (in the frames' dtype, as JAX adds
    them) are brought to the model's dtype; JAX would instead promote a
    bf16 stream against float32 weights op by op."""
    B, F, D = frame_embeds.shape
    pos = torch.arange(F, device=frame_embeds.device)[None].expand(B, F)
    x = (frame_embeds + sinusoidal(pos, D).to(frame_embeds.dtype)).to(
        L._dtype(cfg))
    zero_pos = torch.zeros((B, F), dtype=torch.long,
                           device=frame_embeds.device)

    def enc_layer(p, x):
        hn = L.apply_norm(cfg, p["ln1"], x)
        h, _ = L.attention(cfg, p["attn"], hn, zero_pos, causal=False,
                           xkv=hn)
        x = x + h
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))

    remat = _remat(cfg)
    context_fn = L.remat_policy(cfg) if remat else None
    for p in params["enc_layers"]:
        x = (checkpoint(enc_layer, p, x, use_reentrant=False,
                        context_fn=context_fn) if remat else enc_layer(p, x))
    return L.apply_norm(cfg, params["enc_norm"], x)


def decode(cfg: ModelConfig, params, tokens, enc_out, *, positions=None,
           caches=None, logits_slice=None, executor: str = "auto"):
    """The decoder stack.  ``caches``: the list of per-layer self-attention
    KV caches (written in place; the returned list replaces it) or None.
    ``enc_out`` is brought to the model's dtype (for a float32 model, the
    exact upcast of JAX's promotion of bf16 frames).
    Returns (logits [B, T, padded vocab], new_caches)."""
    B, T = tokens.shape
    enc_out = enc_out.to(L._dtype(cfg))
    from_start = positions is None
    if positions is None:
        positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    x = params["embed"][tokens.long()] + sinusoidal(
        positions, cfg.d_model).to(params["embed"].dtype)

    def dec_layer(p, x, cache):
        h, c2 = L.attention(cfg, p["self_attn"],
                            L.apply_norm(cfg, p["ln1"], x), positions,
                            causal=True, cache=cache, from_start=from_start,
                            executor=executor)
        x = x + h
        h, _ = L.attention(cfg, p["cross_attn"],
                           L.apply_norm(cfg, p["ln_x"], x), positions,
                           causal=False, xkv=enc_out)
        x = x + h
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x)), c2

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

    x = L.apply_norm(cfg, params["dec_norm"], x)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = x @ params["embed"].T.to(x.dtype)
    pv = params["embed"].shape[0]
    if pv != cfg.vocab_size:   # mask the vocab-padding slots
        pad = torch.arange(pv, device=logits.device) >= cfg.vocab_size
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
    with torch.no_grad() if caches is not None else \
            contextlib.nullcontext():
        if enc_out is None:
            enc_out = encode(cfg, params, frame_embeds)
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
