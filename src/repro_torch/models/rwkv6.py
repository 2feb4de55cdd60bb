"""RWKV-6 "Finch" (arXiv:2404.05892), the attention-free LM of the ``ssm``
family: rwkv6-7b (the port of ``repro/models/rwkv6.py``).

Data-dependent token shift (``ddlerp`` with low-rank adapters),
data-dependent per-channel decay ``w_t`` (float32), bonus ``u``, a
matrix-valued WKV state per head (head width 64), gated output with a
per-head GroupNorm, and the squared-ReLU channel mix.

Parameters keep JAX's tree: ``embed``, ``ln0``, ``blocks`` (every leaf
stacked over layers [L, ...]), ``ln_out``, ``head``; a Python loop over
layers takes the place of ``lax.scan``.  JAX's temporal path is a
``lax.scan``; the port runs the WKV recurrence through
``kernels/rwkv6`` (the CUDA kernel on a card, its plain loop on the CPU)
for the forward with and without a state alike: without one the kernel
starts from zero, as the TPU kernel does.  Decode states are JAX's stacked
triple (``tm_last`` [L, B, D], ``S`` [L, B, H, 64, 64] float32,
``cm_last`` [L, B, D]); the forward returns new ones, the token-shift
carries in the activation dtype, as JAX's scan returns them.

Training runs each block under ``torch.utils.checkpoint`` when
``cfg.remat`` (JAX's ``jax.checkpoint`` per block, rwkv6.py:263-267), the
WKV recurrence through its autograd Function (``kernels/rwkv6/ops.py::
WKV``: the forward kernel, then the backward kernel, which walks the
states again from the saved inputs); the decay's gradient flows on
through ``w = exp(-exp(dec))`` into ``w0``, ``w_A`` and ``w_B`` by
autograd.  The mesh helpers
(``_head_shard``, ``residual_shard``, ``logits_shard``) have no
counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.rwkv6 import wkv
from . import layers as L
from .common import ModelConfig
from .lm import _stacked, _to, _unstack

HEAD_DIM = 64
LORA_MIX = 32
LORA_DECAY = 64


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def _full(shape, value):
    return torch.full(shape, value, dtype=torch.float32)


def _ln_params(d):
    return {"scale": torch.ones((d,), dtype=torch.float32),
            "bias": torch.zeros((d,), dtype=torch.float32)}


def init_time_mix(cfg: ModelConfig, gen):
    d = cfg.d_model
    dt = L._dtype(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        # ddlerp: 5 targets (r, k, v, g, w): base mu + rank-LORA_MIX adapter
        "mu": _full((5, d), 0.5),
        "mix_A": L._normal(gen, (5, d, LORA_MIX), s, dt),
        "mix_B": L._normal(gen, (5, LORA_MIX, d), 0.01, dt),
        # decay: w_t = exp(-exp(w0 + lora(xw)))
        "w0": _full((d,), -6.0),
        "w_A": L._normal(gen, (d, LORA_DECAY), s, dt),
        "w_B": L._normal(gen, (LORA_DECAY, d), 0.01, dt),
        "u": _full((d,), 0.5),
        "wr": L._normal(gen, (d, d), s, dt),
        "wk": L._normal(gen, (d, d), s, dt),
        "wv": L._normal(gen, (d, d), s, dt),
        "wg": L._normal(gen, (d, d), s, dt),
        "wo": L._normal(gen, (d, d), s, dt),
        "gn_scale": torch.ones((d,), dtype=torch.float32),
    }


def init_channel_mix(cfg: ModelConfig, gen):
    d, ff = cfg.d_model, cfg.d_ff
    dt = L._dtype(cfg)
    return {
        "mu_k": _full((d,), 0.5),
        "mu_r": _full((d,), 0.5),
        "wk": L._normal(gen, (d, ff), 1.0 / math.sqrt(d), dt),
        "wv": L._normal(gen, (ff, d), 1.0 / math.sqrt(ff), dt),
        "wr": L._normal(gen, (d, d), 1.0 / math.sqrt(d), dt),
    }


def init_block(cfg: ModelConfig, gen):
    return {"ln1": _ln_params(cfg.d_model), "tm": init_time_mix(cfg, gen),
            "ln2": _ln_params(cfg.d_model), "cm": init_channel_mix(cfg, gen)}


def init_params(cfg: ModelConfig, seed=0, *, device=None):
    """Random parameters in JAX's tree and init scales, drawn from a
    ``torch.Generator`` (``seed`` is an int, for a CPU generator, or a
    generator, whose device draws), then moved to ``device`` (default: the
    CUDA card; raises without one; ``"meta"``: the shapes alone, nothing
    drawn)."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    dt = L._dtype(cfg)
    params = {"embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                 dt),
              "ln0": _ln_params(cfg.d_model),
              "blocks": _stacked(cfg.num_layers,
                                 lambda: init_block(cfg, gen), dev),
              "ln_out": _ln_params(cfg.d_model),
              "head": L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                dt)}
    return _to(params, dev)


def _ln(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def _group_norm(x, scale, H, eps=1e-5):
    """Per-head GroupNorm of the WKV output: x [B, T, D] viewed [B, T, H,
    hd]."""
    B, T, D = x.shape
    xf = x.reshape(B, T, H, D // H).float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.reshape(B, T, D) * scale).to(x.dtype)


def time_shift(x, last=None):
    """[B, T, D] -> the previous token's activation (zeros, or the carried
    ``last`` [B, D], before the first)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def ddlerp(p, x, xs):
    """Data-dependent token-shift mixing of the 5 targets (Finch eq. 2-4):
    x, xs [B, T, D] -> [5, B, T, D] (the r, k, v, g, w mixes), in the
    activation dtype."""
    dx = xs - x
    mu = p["mu"].to(x.dtype)[:, None, None, :]
    base = x[None] + dx[None] * mu
    t = torch.tanh(torch.einsum("btd,sdr->sbtr", x + 0.5 * dx, p["mix_A"]))
    lo = torch.einsum("sbtr,srd->sbtd", t, p["mix_B"])
    return (base + lo * dx[None]).to(x.dtype)


def time_mix(cfg: ModelConfig, p, x, shift_last=None, S0=None, *,
             executor="auto"):
    """The Finch time mix.  Returns (y, (last token, S_final))."""
    B, T, D = x.shape
    H = _heads(cfg)
    xs = time_shift(x, shift_last)
    xr, xk, xv, xg, xw = ddlerp(p, x, xs)

    r = (xr @ p["wr"]).reshape(B, T, H, HEAD_DIM)
    k = (xk @ p["wk"]).reshape(B, T, H, HEAD_DIM)
    v = (xv @ p["wv"]).reshape(B, T, H, HEAD_DIM)
    g = xg @ p["wg"]

    # The decay stays float32 (rwkv6.py:175-176 in JAX: a bf16 decay near
    # 1.0 loses the long-range memory it exists for).
    dec = p["w0"] + torch.tanh(xw @ p["w_A"]).float() @ p["w_B"].float()
    w = torch.exp(-torch.exp(dec)).reshape(B, T, H, HEAD_DIM)

    u = p["u"].reshape(H, HEAD_DIM)
    y, S = wkv(r, k, v, w, u, S0, executor=executor)
    y = _group_norm(y.reshape(B, T, D), p["gn_scale"], H)
    y = (y * F.silu(g)) @ p["wo"]
    return y, (x[:, -1], S)


def channel_mix(cfg: ModelConfig, p, x, shift_last=None):
    xs = time_shift(x, shift_last)
    xk = (x + (xs - x) * p["mu_k"]).to(x.dtype)
    xr = (x + (xs - x) * p["mu_r"]).to(x.dtype)
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1]


def block_fwd(cfg: ModelConfig, p, x, state=None, *, executor="auto"):
    """state = (tm_last, S, cm_last) or None."""
    tm_last = S0 = cm_last = None
    if state is not None:
        tm_last, S0, cm_last = state
    h, (tm_last2, S2) = time_mix(cfg, p["tm"], _ln(p["ln1"], x), tm_last,
                                 S0, executor=executor)
    x = x + h
    h, cm_last2 = channel_mix(cfg, p["cm"], _ln(p["ln2"], x), cm_last)
    return x + h, (tm_last2, S2, cm_last2)


def forward(cfg: ModelConfig, params, tokens, *, states=None,
            logits_slice: Optional[int] = None, executor: str = "auto",
            **_):
    """Run the LM.

    tokens     [B, T] integer
    states     stacked per-layer (tm_last [L, B, D], S [L, B, H, 64, 64],
               cm_last [L, B, D]) or None
    logits_slice  compute logits of the last ``logits_slice`` positions only
    executor   the WKV sites' implementation (``auto``: the kernel on a
               card, the plain version on the CPU)
    Other keywords (positions, moe_impl) are ignored, as in JAX.
    Returns (logits [B, T, V], new_states or None, aux_loss 0).
    """
    x = _ln(params["ln0"], params["embed"][tokens.long()])
    remat = cfg.remat and states is None and torch.is_grad_enabled()
    sts = []
    for i, bp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        if remat:
            x = checkpoint(block_fwd, cfg, bp, x, None, executor=executor,
                           use_reentrant=False,
                           context_fn=L.remat_policy(cfg))[0]
            continue
        st = None if states is None else tuple(s[i] for s in states)
        x, st2 = block_fwd(cfg, bp, x, st, executor=executor)
        sts.append(st2)
    new_states = None
    if states is not None:
        new_states = tuple(torch.stack(parts) for parts in zip(*sts))

    x = _ln(params["ln_out"], x)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = x @ params["head"]
    return logits, new_states, torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_states(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                device=None):
    """Zero decode states (JAX's ``init_states``; bf16 token-shift carries
    by default, as JAX)."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    H = _heads(cfg)
    n, D = cfg.num_layers, cfg.d_model
    return (torch.zeros((n, batch, D), dtype=dtype, device=dev),
            torch.zeros((n, batch, H, HEAD_DIM, HEAD_DIM),
                        dtype=torch.float32, device=dev),
            torch.zeros((n, batch, D), dtype=dtype, device=dev))
