"""Model zoo of the port (``repro/models``): one functional bundle per
architecture family.

``build(cfg)`` dispatches on ``cfg.family``, as JAX's:
    dense | moe | vlm  -> lm.py       (decoder-only transformer)
    ssm                -> rwkv6.py    (Finch, attention-free)
    hybrid             -> rglru.py    (recurrentgemma: RG-LRU + local
                                       attention)
    audio              -> whisper.py  (encoder-decoder)
Every family serves and trains.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import lm, rglru, rwkv6, whisper
from .common import ModelConfig, MoEConfig  # noqa: F401

#: Forward inputs of the VLM and audio families (JAX's train/step.py
#: ``_EXTRA_KEYS``).
EXTRA_KEYS = ("frame_embeds", "vision_embeds", "mrope_pos")


def logits_width(cfg: ModelConfig) -> int:
    """The width of the forward's whole logits (and of the vocabulary
    table's rows): whisper's padded vocabulary, else ``vocab_size``."""
    return whisper.padded_vocab(cfg) if cfg.family == "audio" else \
        cfg.vocab_size


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Uniform interface over heterogeneous families."""

    cfg: ModelConfig
    init_params: Callable[..., Any]           # (seed, device=None) -> params
    forward: Callable[..., Any]               # (params, tokens, **kw) -> (logits, state, aux)
    init_decode_state: Callable[..., Any]     # (batch, max_len, ...) -> state
    state_kwarg: str                          # name of the decode-state kwarg


def build(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None, cut=None: lm.init_params(
                cfg, seed, device=device, cut=cut),
            forward=lambda params, tokens, **kw: lm.forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: lm.init_caches(cfg, b, m, dtype, device=device),
            state_kwarg="caches",
        )
    if fam == "ssm":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None, cut=None:
            rwkv6.init_params(cfg, seed, device=device, cut=cut),
            forward=lambda params, tokens, **kw: rwkv6.forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: rwkv6.init_states(cfg, b, dtype, device=device),
            state_kwarg="states",
        )
    if fam == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None, cut=None:
            rglru.init_params(cfg, seed, device=device, cut=cut),
            forward=lambda params, tokens, **kw: rglru.forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: rglru.init_states(cfg, b, m, dtype, device=device),
            state_kwarg="states",
        )
    if fam == "audio":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None, cut=None:
            whisper.init_params(cfg, seed, device=device, cut=cut),
            forward=lambda params, tokens, **kw: whisper.forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: whisper.init_caches(cfg, b, m, dtype, device=device),
            state_kwarg="caches",
        )
    raise ValueError(f"unknown family {fam!r}")
