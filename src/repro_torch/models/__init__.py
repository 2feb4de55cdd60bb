"""Model zoo of the port (``repro/models``): one functional bundle per
architecture family.

``build(cfg)`` dispatches on ``cfg.family``:
    dense   -> lm.py     (decoder-only transformer; serves and trains)
    ssm     -> rwkv6.py  (Finch, attention-free; serves and trains)
    hybrid  -> rglru.py  (recurrentgemma: RG-LRU + local attention; serves
               and trains)
The other families, and the VLM/audio inputs of the dense forward, raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import lm, rglru, rwkv6
from .common import ModelConfig, MoEConfig  # noqa: F401

#: Forward inputs of the VLM and audio families (JAX's train/step.py
#: ``_EXTRA_KEYS``), ported with them.
EXTRA_KEYS = ("frame_embeds", "vision_embeds", "mrope_pos")

#: Families still to port, with the ROADMAP queue 1 item that brings each.
_LATER = {"moe": "9e (MoE, VLM and whisper)", "vlm": "9e (MoE, VLM and whisper)",
          "audio": "9e (MoE, VLM and whisper)"}


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
    if fam == "dense":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None: lm.init_params(
                cfg, seed, device=device),
            forward=lambda params, tokens, **kw: _dense_forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: lm.init_caches(cfg, b, m, dtype, device=device),
            state_kwarg="caches",
        )
    if fam == "ssm":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None: rwkv6.init_params(
                cfg, seed, device=device),
            forward=lambda params, tokens, **kw: rwkv6.forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: rwkv6.init_states(cfg, b, dtype, device=device),
            state_kwarg="states",
        )
    if fam == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda seed=0, device=None: rglru.init_params(
                cfg, seed, device=device),
            forward=lambda params, tokens, **kw: rglru.forward(
                cfg, params, tokens, **kw),
            init_decode_state=lambda b, m, dtype=torch.bfloat16,
            device=None: rglru.init_states(cfg, b, m, dtype, device=device),
            state_kwarg="states",
        )
    if fam in _LATER:
        raise NotImplementedError(
            f"the {fam!r} family is not ported yet: ROADMAP queue 1, item "
            f"{_LATER[fam]}")
    raise ValueError(f"unknown family {fam!r}")


def _dense_forward(cfg, params, tokens, *, moe_impl: str = "gmm", **kw):
    """``lm.forward``; ``moe_impl`` is ignored, as JAX ignores it for a
    dense model."""
    extra = [k for k in EXTRA_KEYS if kw.pop(k, None) is not None]
    if extra:
        raise NotImplementedError(
            f"forward inputs {extra} are not ported yet: ROADMAP queue 1, "
            f"item {_LATER['vlm']}")
    return lm.forward(cfg, params, tokens, **kw)
