"""RecurrentGemma / Griffin (arXiv:2402.19427), the ``hybrid`` family:
RG-LRU recurrent blocks and local MQA attention, recurrentgemma-2b (the
port of ``repro/models/rglru.py``).

Block pattern (1 attention : 2 recurrent): layer i is a local-attention
block when ``i % 3 == 2``, else a recurrent block:

    recurrent block:  x -> Wx -> causal depthwise conv1d(w=4) -> RG-LRU ┐
                      x -> Wy -> GeLU ──────────────────────────────────┤⊙ -> Wo
    RG-LRU:  r_t = σ(BD_a x_t);  i_t = σ(BD_x x_t)
             a_t = exp(c · r_t · log σ(Λ))           (c = 8)
             h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Gates use block-diagonal linear maps (8 blocks).  Parameters keep JAX's
tree: ``embed`` (tied head), ``layers`` (a list of per-layer dicts, not
stacked: the two kinds differ), ``final_norm``.

JAX runs the recurrence as ``lax.associative_scan``; the port runs it
through ``kernels/rglru`` (the CUDA kernel on a card, its plain loop on the
CPU), which is the TPU kernel's sequential order, so the two round
differently (ROADMAP queue 3).  Local attention runs ``layers.attention``
with the sliding window: the flash kernel (head width 256, MQA) for a
forward without a state and for a prefill into the empty ring cache, full
scores under the ring's mask in decode.  Decode states are JAX's list: a
ring cache dict per attention layer, ``(conv_state [B, W-1, C], h [B, C]
float32)`` per recurrent layer; the forward returns new recurrent states
and writes the ring caches in place.

The forward without states builds an autograd graph when grad is enabled
(training): the RG-LRU runs ``kernels/rglru``'s ``RGLRUScan`` (kernel 5,
then its backward kernel), the local attention the ``FlashAttention``
Function (kernels 2 and 3 at head width 256).  With ``cfg.remat`` each
layer then runs under ``torch.utils.checkpoint``, as JAX wraps each in
``jax.checkpoint`` (models/rglru.py:166-171), so the backward recomputes
it.

In a partitioned train step (``distributed.sharding.partitioned``) the
recurrent block is a tensor-parallel region on the rank's blocks by
``param_specs``: its columns (channels) of ``wx`` and ``wy`` on the input
gathered whole in T (from the rank's block where
``layers.sequence_parallel`` holds, JAX's ``residual_shard``: the causal
conv needs each token's predecessors), the conv, the gates, the RG-LRU
(kernels 5 and 5b) on those channels, and the row product with its rows
of ``wo``, summed over the axis on the way out.  ``conv_w``, ``conv_b``,
``lam`` and the gates' biases are replicated leaves of which the rank
uses its channels' share (their gradients summed over the axis,
``layers._share``).  A block-diagonal gate's output channel reads its
block's inputs: where the rank's channels are whole blocks those are its
own, else (a share narrower than a block, or across one) the rank's
blocks of the conv output are gathered first (their gradients summed,
then cut).  The local attention and the MLPs are ``layers``' regions; the
tied vocabulary ``lm.embed``'s and ``lm.logits_of``'s.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (copy_to_model, gather_from_model,
                                    model_axis)
from ..kernels.rglru import rglru
from . import layers as L
from . import lm
from .common import ModelConfig
from .lm import _cut_tree, _to

GATE_BLOCKS = 8
LRU_C = 8.0


def is_attn_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.block_pattern[i % len(cfg.block_pattern)] == "local"


def init_block_diag(gen, d, blocks, dt):
    bd = d // blocks
    return {"w": L._normal(gen, (blocks, bd, bd), 1.0 / math.sqrt(bd), dt),
            "b": torch.zeros((d,), dtype=dt)}


def block_diag_apply(p, x, ax=None):
    """x [..., D] with D = blocks * bd.  On a model axis ``ax`` (a
    partitioned step), x is the rank's channels [..., D / size] and so is
    the output: the blocks that hold them, on the rank's own channels
    where those are whole blocks, else on the channels gathered from the
    axis (module docstring)."""
    blocks, bd, _ = p["w"].shape
    C = blocks * bd
    rank, size = (0, 1) if ax is None else (ax.rank, ax.size)
    c0, c1 = C * rank // size, C * (rank + 1) // size
    g0, g1 = c0 // bd, -(-c1 // bd)
    whole = C % size == 0 and (C // size) % bd == 0     # on every rank
    xin = x if whole else gather_from_model(x, ax)[..., g0 * bd:g1 * bd]
    xs = xin.reshape(xin.shape[:-1] + (g1 - g0, bd))
    y = torch.einsum("...gi,gij->...gj", xs, copy_to_model(p["w"], ax)[g0:g1])
    y = y.reshape(xin.shape)[..., c0 - g0 * bd:c1 - g0 * bd]
    return y + L._share(p["b"], ax, -1, C)


def init_recurrent_block(cfg: ModelConfig, gen):
    d = cfg.d_model
    lru = cfg.lru_width or d
    dt = L._dtype(cfg)
    return {
        "wx": L._normal(gen, (d, lru), 1.0 / math.sqrt(d), dt),
        "wy": L._normal(gen, (d, lru), 1.0 / math.sqrt(d), dt),
        "conv_w": L._normal(gen, (cfg.conv_width, lru), 0.1, dt),
        "conv_b": torch.zeros((lru,), dtype=dt),
        "gate_a": init_block_diag(gen, lru, GATE_BLOCKS, dt),
        "gate_x": init_block_diag(gen, lru, GATE_BLOCKS, dt),
        # Λ so that a = σ(Λ) ∈ (0.9, 0.999): long memory at init
        "lam": torch.linspace(2.2, 6.9, lru, dtype=torch.float32),
        "wo": L._normal(gen, (lru, d), 1.0 / math.sqrt(lru), dt),
    }


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv.  x [B, T, C], w [W, C], state [B, W-1, C] or
    None.  Returns (y [B, T, C], new_state [B, W-1, C])."""
    W = w.shape[0]
    pad = torch.zeros_like(x[:, :W - 1]) if state is None else \
        state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W)) + b
    return y, xp[:, -(W - 1):]


def rg_lru(p, x, h0=None, *, executor="auto"):
    """x [B, T, C] -> (y [B, T, C] in x's dtype, h_last [B, C] float32).
    The carried state is folded into the first step (``b_0 += a_0 h0``),
    then the scan runs from zero.  In a partitioned step x is the rank's
    channels of the whole C = ``lam``'s length."""
    xf = x.float()
    ax = model_axis()
    r = torch.sigmoid(block_diag_apply(p["gate_a"], x, ax).float())
    i = torch.sigmoid(block_diag_apply(p["gate_x"], x, ax).float())
    lam = L._share(p["lam"], ax, -1, p["lam"].shape[-1])
    log_a1 = -F.softplus(-lam)                       # log σ(Λ) < 0
    log_at = LRU_C * r * log_a1
    a = torch.exp(log_at)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_at),
                                       1e-12)) * (i * xf)
    if h0 is not None:
        # b_0 += a_0 h0, out of place: no view of gated is written
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0.float()[:, None],
                           gated[:, 1:]], dim=1)
    h = rglru(a, gated, executor=executor)
    return h.to(x.dtype), h[:, -1]


def recurrent_block(cfg: ModelConfig, p, x, state=None, *, executor="auto",
                    seq=False):
    """state = (conv_state [B, W-1, C], h [B, C]) or None.  In a
    partitioned step (module docstring; ``seq``: x and the output are the
    rank's sequence blocks) no state is returned."""
    conv_st = h0 = None
    if state is not None:
        conv_st, h0 = state
    ax = model_axis()
    if ax is not None and state is not None:
        raise ValueError("a partitioned step runs the RG-LRU without a "
                         "state")
    C = p["lam"].shape[-1]
    x = L._enter(x, ax, seq)
    u = x @ L._share(p["wx"], ax, -1, C)
    u, conv_st2 = causal_conv1d(u, L._share(p["conv_w"], ax, -1, C),
                                L._share(p["conv_b"], ax, -1, C), conv_st)
    u, h_last = rg_lru(p, u, h0, executor=executor)
    gate = F.gelu(x @ L._share(p["wy"], ax, -1, C), approximate="tanh")
    y = L._leave((u * gate) @ L._share(p["wo"], ax, 0, C), ax, seq)
    return y, (conv_st2, h_last) if ax is None else None


def init_layer(cfg: ModelConfig, gen, i: int):
    p = {"ln1": L.init_norm(cfg, cfg.d_model),
         "ln2": L.init_norm(cfg, cfg.d_model)}
    if is_attn_layer(cfg, i):
        p["attn"] = L.init_attention(cfg, gen)
    else:
        p["rec"] = init_recurrent_block(cfg, gen)
    p["mlp"] = L.init_mlp(cfg, gen)
    return p


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
    keep = cut or (lambda path, x, stacked: x)
    embed = keep(("embed",), L._normal(
        gen, (cfg.vocab_size, cfg.d_model), 0.02, L._dtype(cfg)), False)
    return {"embed": embed.to(dev),
            "layers": [_to(_cut_tree(init_layer(cfg, gen, i),
                                     ("layers", i), keep), dev)
                       for i in range(cfg.num_layers)],
            "final_norm": _to(L.init_norm(cfg, cfg.d_model), dev)}


def _layer_fwd(cfg: ModelConfig, i, p, x, positions, state, *, from_start,
               executor, seq=False):
    """Layer ``i``: (x, its new state).  ``seq``: x is the rank's block of
    a partitioned step's sequence-parallel stream."""
    hn = L.apply_norm(cfg, p["ln1"], x, seq=seq)
    if is_attn_layer(cfg, i):
        h, st2 = L.attention(cfg, p["attn"], hn, positions, causal=True,
                             window=cfg.sliding_window, cache=state,
                             from_start=from_start, executor=executor,
                             seq=seq)
    else:
        h, st2 = recurrent_block(cfg, p["rec"], hn, state,
                                 executor=executor, seq=seq)
    x = x + h
    return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x, seq=seq),
                     seq=seq), st2


def forward(cfg: ModelConfig, params, tokens, *, positions=None,
            states=None, logits_slice: Optional[int] = None,
            executor: str = "auto", **_):
    """Run the LM.

    tokens     [B, T] integer
    positions  [B, T] (defaults to 0..T-1; decode passes the absolute
               positions)
    states     the per-layer list of :func:`init_states` or None; ring
               caches are written in place, recurrent states returned anew
    logits_slice  compute logits of the last ``logits_slice`` positions only
    executor   the flash-attention and RG-LRU sites' implementation
               (``auto``: the kernels on a card, the plain versions on the
               CPU)
    Returns (logits [B, T, V], new_states or None, aux_loss 0).
    RecurrentGemma scales the embeddings by sqrt(d_model).
    """
    B, T = tokens.shape
    # the residual stream cut by sequence (JAX's residual_shard,
    # rglru.py:153; a forward without a state, whose logits are all kept)
    seq = (states is None and logits_slice is None
           and L.sequence_parallel(cfg, model_axis(), T))
    emb = params["embed"]
    x = lm.embed(cfg, params, tokens, seq) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=emb.dtype)
    from_start = positions is None
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)

    remat = cfg.remat and states is None and torch.is_grad_enabled()
    new_states = [] if states is not None else None
    for i, p in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_layer_fwd, cfg, i, p, x, positions, None,
                           from_start=from_start, executor=executor,
                           seq=seq, use_reentrant=False,
                           context_fn=L.remat_policy(cfg))[0]
            continue
        st = states[i] if states is not None else None
        x, st2 = _layer_fwd(cfg, i, p, x, positions, st,
                            from_start=from_start, executor=executor,
                            seq=seq)
        if states is not None:
            new_states.append(st2)

    x = L.apply_norm(cfg, params["final_norm"], x, seq=seq)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = lm.logits_of(cfg, params, x, seq)
    return logits, new_states, torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_states(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device=None):
    """Decode states: a ring cache of ``min(max_len, window)`` slots per
    local-attention layer, zero (conv, h) per recurrent layer (JAX's
    ``init_states``; bf16 by default, h float32)."""
    from ..api.scenario import resolve_device

    dev = resolve_device(device)
    lru = cfg.lru_width or cfg.d_model
    cache_len = min(max_len, cfg.sliding_window or max_len)
    states = []
    for i in range(cfg.num_layers):
        if is_attn_layer(cfg, i):
            states.append(L.init_cache(cfg, batch, cache_len, dtype,
                                       ring=True, device=dev))
        else:
            states.append((torch.zeros((batch, cfg.conv_width - 1, lru),
                                       dtype=dtype, device=dev),
                           torch.zeros((batch, lru), dtype=torch.float32,
                                       device=dev)))
    return states
