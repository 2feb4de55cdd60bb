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
autograd.

In a partitioned train step (``distributed.sharding.partitioned``) the
time mix and the channel mix are tensor-parallel regions on the rank's
blocks by ``param_specs``, as GSPMD partitions JAX's placed step (JAX's
``_head_shard`` puts the WKV's heads on 'model').  Each region takes its
input whole in T (gathered over T from the rank's block where
``layers.sequence_parallel`` holds, JAX's ``residual_shard``), because
the token shift needs every token's predecessor, and runs the shift and
``ddlerp`` there alike on every rank.  The time mix computes the rank's
heads: ``wr``/``wk``/``wv``/``wg``'s columns (whole heads of 64 where the
axis divides H; else every head on every rank, the column blocks
gathered), the WKV kernel on those heads, the per-head GroupNorm, and the
row product with its rows of ``wo``, summed over the axis on the way out.
The replicated leaves it reads (the LoRAs, ``mu``, ``w0``, ``u``,
``gn_scale``) enter the region, so their gradients, partial on each rank,
are summed over the axis (``w0``, ``u``, ``gn_scale`` and ``w_B``'s output
columns as the rank's share, ``layers._share``'s rule).  The channel mix
computes its columns of ``wk`` and the row product with ``wv`` (summed
over the axis), and ``sigmoid(xr @ wr)`` on its columns of ``wr``,
gathered over D to meet that sum: into the replicated stream (gradient
cut only) or, under sequence parallelism, inside the region and narrowed
to the rank's block (gradient summed, then cut).  The vocabulary is
``lm.embed``'s and ``lm.logits_of``'s; the LayerNorms on the rank's block
have their parameters' gradients summed over the axis.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (copy_to_model, gather_from_model,
                                    gather_out_of_model, model_axis,
                                    sequence_block)
from ..kernels.rwkv6 import wkv
from . import layers as L
from . import lm
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


def init_params(cfg: ModelConfig, seed=0, *, device=None, cut=None):
    """Random parameters in JAX's tree and init scales, drawn from a
    ``torch.Generator`` (``seed`` is an int, for a CPU generator, or a
    generator, whose device draws), then moved to ``device`` (default: the
    CUDA card; raises without one; ``"meta"``: the shapes alone, nothing
    drawn).  ``cut(path, leaf, stacked)``: what of each leaf is kept as
    it is drawn (``lm.init_params``'s)."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    dt = L._dtype(cfg)
    keep = cut or (lambda path, x, stacked: x)
    params = {"embed": keep(("embed",), L._normal(
                  gen, (cfg.vocab_size, cfg.d_model), 0.02, dt), False),
              "ln0": _ln_params(cfg.d_model),
              "blocks": _stacked(cfg.num_layers,
                                 lambda: init_block(cfg, gen), dev,
                                 lambda path, x: keep(("blocks",) + path, x,
                                                      True)),
              "ln_out": _ln_params(cfg.d_model),
              "head": keep(("head",), L._normal(
                  gen, (cfg.d_model, cfg.vocab_size), 0.02, dt), False)}
    return _to(params, dev)


def _ln(p, x, eps=1e-5, seq=False):
    """LayerNorm; ``seq``: x is the rank's sequence block of a partitioned
    step (the parameters enter the region: their gradients summed)."""
    if seq:
        ax = model_axis()
        p = {k: copy_to_model(v, ax) for k, v in p.items()}
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


def _rank_heads(H: int, ax) -> tuple:
    """(first head, heads) the rank computes: its H / size where the
    axis divides H, else every head (every head without an axis)."""
    if ax is None or H % ax.size:
        return 0, H
    return ax.rank * (H // ax.size), H // ax.size


def time_mix(cfg: ModelConfig, p, x, shift_last=None, S0=None, *,
             executor="auto", seq=False):
    """The Finch time mix.  Returns (y, (last token, S_final)).  In a
    partitioned step (module docstring) y is the rank's block of the
    stream under ``seq``, else whole; the carries are not returned."""
    B, T, D = x.shape
    H = _heads(cfg)
    ax = model_axis()
    if ax is not None:
        if S0 is not None or shift_last is not None:
            raise ValueError("a partitioned step runs rwkv6 without a state")
        x = L._enter(x, ax, seq)
        T = x.shape[1]
        # ddlerp's and the decay LoRA's input side, run alike on every
        # rank; the rest by the rank's heads below
        p = dict(p, **{k: copy_to_model(p[k], ax)
                       for k in ("mu", "mix_A", "mix_B", "w_A")})
    h0, nh = _rank_heads(H, ax)

    def cols(w):        # the rank's heads' last-dim columns of w
        return L._head_cols(w, ax, h0, nh, HEAD_DIM, H)
    xs = time_shift(x, shift_last)
    xr, xk, xv, xg, xw = ddlerp(p, x, xs)

    r = (xr @ cols(p["wr"])).reshape(B, T, nh, HEAD_DIM)
    k = (xk @ cols(p["wk"])).reshape(B, T, nh, HEAD_DIM)
    v = (xv @ cols(p["wv"])).reshape(B, T, nh, HEAD_DIM)
    g = xg @ cols(p["wg"])

    # The decay stays float32 (rwkv6.py:175-176 in JAX: a bf16 decay near
    # 1.0 loses the long-range memory it exists for).
    dec = cols(p["w0"]) + torch.tanh(xw @ p["w_A"]).float() @ cols(
        p["w_B"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(B, T, nh, HEAD_DIM)

    u = cols(p["u"]).reshape(nh, HEAD_DIM)
    y, S = wkv(r, k, v, w, u, S0, executor=executor)
    y = _group_norm(y.reshape(B, T, nh * HEAD_DIM), cols(p["gn_scale"]), nh)
    y = L._rows_out(y * F.silu(g), p["wo"], ax, D, seq)
    return y, (x[:, -1], S) if ax is None else None


def channel_mix(cfg: ModelConfig, p, x, shift_last=None, seq=False):
    """The squared-ReLU channel mix.  Returns (y, last token); in a
    partitioned step (module docstring) y is the rank's block under
    ``seq``, else whole (the token of no use: there is no state)."""
    ax = model_axis()
    D, F_ = cfg.d_model, cfg.d_ff
    if ax is not None and (shift_last is not None or p["wr"].shape[-1] == D):
        raise ValueError(f"a partitioned step runs rwkv6 without a state, "
                         f"the channel mix's wr cut over the model axis of "
                         f"{ax.size} (it must divide D = {D})")
    x = L._enter(x, ax, seq)
    xs = time_shift(x, shift_last)
    xk = (x + (xs - x) * copy_to_model(p["mu_k"], ax)).to(x.dtype)
    xr = (x + (xs - x) * copy_to_model(p["mu_r"], ax)).to(x.dtype)
    k = torch.square(torch.relu(xk @ L._share(p["wk"], ax, -1, F_)))
    kv = L._leave(k @ L._share(p["wv"], ax, 0, F_), ax, seq)
    r = torch.sigmoid(xr @ p["wr"])         # the rank's columns, every t
    if ax is not None:
        t0, n = sequence_block(x.shape[1], ax if seq else None)
        r = (gather_from_model(r, ax).narrow(1, t0, n) if seq
             else gather_out_of_model(r, ax))
    return r * kv, x[:, -1]


def block_fwd(cfg: ModelConfig, p, x, state=None, *, executor="auto",
              seq=False):
    """state = (tm_last, S, cm_last) or None.  ``seq``: x is the rank's
    block of a partitioned step's sequence-parallel stream."""
    tm_last = S0 = cm_last = None
    if state is not None:
        tm_last, S0, cm_last = state
    h, st = time_mix(cfg, p["tm"], _ln(p["ln1"], x, seq=seq), tm_last, S0,
                     executor=executor, seq=seq)
    x = x + h
    h, cm_last2 = channel_mix(cfg, p["cm"], _ln(p["ln2"], x, seq=seq),
                              cm_last, seq=seq)
    return x + h, None if st is None else (*st, cm_last2)


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
    # the residual stream cut by sequence (JAX's residual_shard,
    # rwkv6.py:244; a forward without a state, whose logits are all kept)
    seq = (states is None and logits_slice is None
           and L.sequence_parallel(cfg, model_axis(), tokens.shape[1]))
    x = _ln(params["ln0"], lm.embed(cfg, params, tokens, seq), seq=seq)
    remat = cfg.remat and states is None and torch.is_grad_enabled()
    sts = []
    for i, bp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        if remat:
            x = checkpoint(block_fwd, cfg, bp, x, None, executor=executor,
                           seq=seq, use_reentrant=False,
                           context_fn=L.remat_policy(cfg))[0]
            continue
        st = None if states is None else tuple(s[i] for s in states)
        x, st2 = block_fwd(cfg, bp, x, st, executor=executor, seq=seq)
        sts.append(st2)
    new_states = None
    if states is not None:
        new_states = tuple(torch.stack(parts) for parts in zip(*sts))

    x = _ln(params["ln_out"], x, seq=seq)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = lm.logits_of(cfg, params, x, seq)
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
