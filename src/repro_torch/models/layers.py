"""Shared neural layers of the decoder-only LMs (dense, MoE, VLM), of
whisper and of recurrentgemma's local attention (the port of
``repro/models/layers.py``; functional style over parameter dicts).

Conventions, as in the JAX package:
  * params are nested dicts of tensors, weights in JAX's ``[in, out]``
    layout, so carrying them across is a copy;
  * activations are [B, T, D] in the config's dtype, math in float32 where
    it matters (softmax, norms);
  * k/v stay un-repeated ([B, T, Hkv, hd]) and the attention einsums are
    GQA-grouped.

Causal attention over a sequence that starts at position 0 -- a forward
without a cache with Tq > 1, or a prefill into an empty (contiguous or
ring) cache -- runs the flash attention kernel (``kernels/flash_attention``);
decode, Tq > 1 into a non-empty cache and non-causal attention (whisper's
encoder and cross-attention) use :func:`attention_scores_full`,
as JAX does for them (or for a short sequence).  Which one
runs is decided from shapes and host state (the cache's write offset is a
Python int), never by a device read.  Attention without a cache is
differentiable: under autograd the kernel site runs the
``FlashAttention`` Function (forward kernel with LSE, backward kernel), and
:func:`attention_scores_full` is plain autograd.

Caches are written in place (JAX returns new ones): a KV cache is the
largest tensor of a serving run (7.5 GB for 16 slots x 4,096 positions of
qwen3-0.6b), so the port never copies it.  A cache dict passed to
:func:`attention` must not be reused after the call; use the one returned.

The ring-buffer cache of windowed attention (``init_cache(ring=True)``,
JAX's layers.py:321-335, 360-368) holds the last ``max_len`` keys with
their absolute positions (``pos``, -1 where never written): a write lands
at ``idx % max_len``, and the mask hides unwritten slots, later positions
and keys a window or more behind.  A write that does not fit between its
slot and the ring's end raises ``ValueError`` (JAX raises for a prefill
longer than the ring, and clamps the start of one that would wrap).

The MoE layers (JAX's layers.py:464-556) route in float32 and run the
experts as plain PyTorch, as JAX leaves them to XLA: :func:`moe_gmm` sorts
the (token, expert) pairs by expert and runs one ``torch.matmul`` per
expert over its contiguous rows (``lax.ragged_dot``), skipping empty
experts; its group sizes come to the host once a call.  Each token's k
weighted expert outputs are summed in JAX's scatter order (ascending
expert id), one add at a time in the activations' dtype, never by atomics.

No counterpart here: ``residual_shard``, ``logits_shard`` and ``_cp_shard``
(mesh constraints; this port runs on one card).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import noop_context_fn

from ..kernels.flash_attention import flash_attention
from .common import ModelConfig

NEG_INF = -2.0e38


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def generator(seed, device):
    """The generator an ``init_params`` draws from: ``seed`` itself if it
    is a ``torch.Generator`` (whose device draws), else a CPU generator
    seeded with it; None on the ``meta`` device, where nothing is drawn
    (the port's ``jax.eval_shape``: :func:`_normal` then returns meta
    tensors of the real shapes and dtypes)."""
    if torch.device(device).type == "meta":
        return None
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))


def _normal(gen, shape, scale, dtype):
    """float32 standard normals from ``gen``, on the generator's device,
    scaled and cast (with ``gen`` None, an empty meta tensor)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def remat_policy(cfg: ModelConfig):
    """What a rematerialised block keeps for the backward (JAX's
    layers.py:63-70), as ``torch.utils.checkpoint``'s ``context_fn``.
    ``'nothing'`` recomputes the whole block and keeps only its inputs (the
    default context).  ``'dots'`` (JAX's ``dots_with_no_batch_dims_saveable``)
    is not ported: no config uses it (ROADMAP queue 1, item 9e)."""
    if getattr(cfg, "remat_save", "nothing") == "dots":
        raise NotImplementedError("remat_save='dots' is not ported (ROADMAP "
                                  "queue 1, item 9e); every config uses "
                                  "'nothing'")
    return noop_context_fn


# ----------------------------------------------------------------- norms ---

def init_norm(cfg: ModelConfig, d: int):
    if cfg.norm_type == "ln_nonparam":        # olmo: no learnable affine
        return {}
    if cfg.norm_type == "ln":
        return {"scale": torch.ones((d,), dtype=torch.float32),
                "bias": torch.zeros((d,), dtype=torch.float32)}
    return {"scale": torch.ones((d,), dtype=torch.float32)}


def _norm_impl(norm_type: str, p, x, eps: float = 1e-6):
    xf = x.float()
    if norm_type in ("ln", "ln_nonparam"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if norm_type == "ln":
            y = y * p["scale"] + p["bias"]
    else:                                      # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6):
    return _norm_impl(cfg.norm_type, p, x, eps)


def rms_head_norm(x, scale, eps: float = 1e-6):
    """qk-norm (qwen3): RMS-normalize each head vector."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ------------------------------------------------------------------ rope ---

def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [..., T] -> cos/sin [..., T, head_dim//2] (float32)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, T, H, hd]; cos/sin broadcastable to [B, T, 1, hd//2]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def mrope_cos_sin(positions3, sections, head_dim: int, theta: float):
    """M-RoPE (qwen2-vl): positions3 [3, B, T] (t/h/w), ``sections`` split
    the rotary dims among the three rows (truncated to head_dim // 2).
    Returns cos/sin [B, T, 1, hd//2].  JAX selects each dim's row by a
    one-hot einsum; a gather takes the same values exactly."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions3.device) / half)
    ang = positions3[..., None].float() * freqs            # [3, B, T, half]
    idx = [i for i, s in enumerate(sections) for _ in range(s)][:half]
    if len(idx) != half:
        raise ValueError(f"mrope_sections {sections} cover {len(idx)} of "
                         f"{half} rotary dims")
    dims = torch.arange(half, device=ang.device)
    ang = ang[torch.as_tensor(idx, device=ang.device), :, :, dims]
    ang = ang.permute(1, 2, 0)                              # [B, T, half]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


# ------------------------------------------------------------- attention ---

def init_attention(cfg: ModelConfig, gen, cross: bool = False):
    """Attention weights; ``cross`` (whisper's cross-attention) has no QKV
    biases."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    s = 1.0 / math.sqrt(d)
    dt = _dtype(cfg)
    p = {
        "wq": _normal(gen, (d, h * hd), s, dt),
        "wk": _normal(gen, (d, hkv * hd), s, dt),
        "wv": _normal(gen, (d, hkv * hd), s, dt),
        "wo": _normal(gen, (h * hd, d), s, dt),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h * hd,), dtype=dt)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32)
    return p


def _qkv(cfg: ModelConfig, p, x, xkv=None):
    hd = cfg.resolved_head_dim
    xkv = x if xkv is None else xkv
    q = x @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, T = x.shape[:2]
    Tk = xkv.shape[1]
    q = q.reshape(B, T, cfg.num_heads, hd)
    k = k.reshape(B, Tk, cfg.num_kv_heads, hd)
    v = v.reshape(B, Tk, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    return q, k, v


def attention_scores_full(q, k, v, mask_bias):
    """Reference full-matrix attention, GQA-grouped.

    q [B,Tq,H,hd]; k/v [B,Tk,Hkv,hd] (not head-repeated); mask_bias
    broadcastable to [B,1,1,Tq,Tk].  Scores are rounded to q's dtype before
    the float32 softmax, as JAX's einsum does."""
    B, Tq, H, hd = q.shape
    hkv = k.shape[2]
    rep = H // hkv
    qg = q.reshape(B, Tq, hkv, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    s = s / math.sqrt(hd) + mask_bias
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return o.reshape(B, Tq, H, hd)


def _write_cache(cache, k, v, positions, from_start):
    """Write this step's k/v into the cache in place; return the keys and
    values to attend over (in the cache's dtype)."""
    ck, cv = cache["k"], cache["v"]
    T = k.shape[1]
    if T > ck.shape[1]:
        raise ValueError(f"cache overflow: {T} positions into a cache of "
                         f"{ck.shape[1]}")
    rows = cache.get("rows")
    if cache.get("per_row"):
        # Per-row write offsets (continuous batching): each slot writes at
        # its own positions; only the live rows are written, so frozen
        # slots keep their state.
        if rows is None:
            rows = torch.arange(k.shape[0], device=k.device)
        if from_start:
            ck[rows, :T] = k[rows].to(ck.dtype)
            cv[rows, :T] = v[rows].to(cv.dtype)
        else:
            offs = positions[rows].long()
            ck[rows[:, None], offs] = k[rows].to(ck.dtype)
            cv[rows[:, None], offs] = v[rows].to(cv.dtype)
    else:
        idx = cache["idx"]
        if idx + T > ck.shape[1]:
            raise ValueError(f"cache overflow: writing {T} positions at "
                             f"{idx} into a cache of {ck.shape[1]}")
        ck[:, idx:idx + T] = k.to(ck.dtype)
        cv[:, idx:idx + T] = v.to(cv.dtype)
    return ck, cv


def _write_ring(cache, k, v, positions):
    """Write this step's k/v and positions into the ring at ``idx % len``
    in place; return the ring's keys and values."""
    ck, cv = cache["k"], cache["v"]
    T, clen = k.shape[1], ck.shape[1]
    slot = cache["idx"] % clen
    if slot + T > clen:
        raise ValueError(f"ring cache overflow: writing {T} positions at "
                         f"slot {slot} of a ring of {clen}")
    ck[:, slot:slot + T] = k.to(ck.dtype)
    cv[:, slot:slot + T] = v.to(cv.dtype)
    cache["pos"][:, slot:slot + T] = positions.to(torch.int32)
    return ck, cv


def attention(cfg: ModelConfig, p, x, positions, *, causal=True, window=0,
              cache=None, from_start=False, xkv=None, mrope_pos=None,
              executor="auto"):
    """Unified attention: forward without a cache, prefill, and decode.

    cache: None -> plain forward over x; a layer cache dict
    (``k``, ``v``, ``idx`` [host int], ``per_row``, optional ``rows``, and
    ``pos`` for a ring) -> write x's k/v at ``idx`` (contiguous), at
    ``idx % len`` (ring) or at ``positions`` (per row) and attend over the
    cache.  ``from_start``: the caller's positions are
    0..T-1 in every row (host knowledge; the forward's default).
    ``xkv`` [B, Tk, D]: keys and values from it (cross-attention, or
    whisper's encoder with xkv = x), without the rotary embedding.
    ``mrope_pos`` [3, B, T]: M-RoPE positions, used when ``cfg.mrope``.
    ``executor`` picks the flash-attention sites' implementation
    (``auto``/``cuda``/``reference``, kernels/flash_attention/ops.py).
    Returns (y [B,T,D], new_cache_or_None).  Without a cache, causal
    attention over Tq > 1 runs the kernel, which covers both of JAX's
    branches (full scores, and ``attention_chunked`` past ``q_chunk``).
    """
    q, k, v = _qkv(cfg, p, x, xkv)
    hd = cfg.resolved_head_dim

    if xkv is None and cfg.use_rope:
        if cfg.mrope and mrope_pos is not None:
            cos, sin = mrope_cos_sin(mrope_pos, cfg.mrope_sections, hd,
                                     cfg.rope_theta)
        else:
            cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
            cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    B, Tq = q.shape[:2]
    new_cache = None
    ring = cache is not None and "pos" in cache
    if cache is not None:
        ck, cv = (_write_ring(cache, k, v, positions) if ring else
                  _write_cache(cache, k, v, positions, from_start))
        new_cache = dict(cache, idx=cache["idx"] + Tq)
        if from_start and cache["idx"] == 0 and Tq > 1:
            # Prefill into an empty cache: causal attention over the first
            # Tq keys, read back from the cache and brought to q's dtype (a
            # bf16 cache under a float32 model: the exact upcast JAX's
            # mixed einsum does).  In a ring these sit at slots 0..Tq-1.
            y = flash_attention(q, ck[:, :Tq].to(q.dtype),
                                cv[:, :Tq].to(q.dtype), causal=True,
                                window=window, executor=executor)
        elif ring:
            # The ring's mask from the absolute positions of its slots.
            kpos = cache["pos"]
            dist = positions[:, :, None] - kpos[:, None, :]
            m = (dist < 0) | (kpos[:, None, :] < 0)
            if window > 0:
                m |= dist >= window
            bias = torch.where(m[:, None, None], NEG_INF, 0.0)
            y = attention_scores_full(q, ck.to(q.dtype), cv.to(q.dtype), bias)
        else:
            # decode / cached attention: causal per-row mask; a contiguous
            # cache also hides never-written slots past the write index.
            Tk = ck.shape[1]
            kpos = torch.arange(Tk, device=x.device)
            qpos = positions
            m = kpos[None, None, :] > qpos[:, :, None]
            if window > 0:
                m |= kpos[None, None, :] <= (qpos[:, :, None] - window)
            if not cache.get("per_row"):
                m |= (kpos >= cache["idx"] + Tq)[None, None, :]
            bias = torch.where(m[:, None, None], NEG_INF, 0.0)
            y = attention_scores_full(q, ck.to(q.dtype), cv.to(q.dtype), bias)
    elif Tq > 1 and causal:
        y = flash_attention(q, k, v, causal=True, window=window,
                            executor=executor)
    else:
        # One query, or non-causal attention (JAX ignores the window
        # there): full scores, JAX's branch for a short sequence.
        bias = torch.zeros((1, 1, 1, 1, 1), dtype=torch.float32,
                           device=x.device)
        y = attention_scores_full(q, k, v, bias)

    y = y.reshape(B, Tq, cfg.num_heads * hd) @ p["wo"]
    return y, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, ring: bool = False,
               per_row: bool = False, device=None):
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "idx": 0, "per_row": per_row}
    if ring:
        c["pos"] = torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device)
    return c


# ------------------------------------------------------------------- mlp ---

def init_mlp(cfg: ModelConfig, gen, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "wg": _normal(gen, (d, ff), s_in, dt),
            "wu": _normal(gen, (d, ff), s_in, dt),
            "wd": _normal(gen, (ff, d), s_out, dt),
        }
    return {  # gelu mlp (whisper)
        "wu": _normal(gen, (d, ff), s_in, dt),
        "bu": torch.zeros((ff,), dtype=dt),
        "wd": _normal(gen, (ff, d), s_out, dt),
        "bd": torch.zeros((cfg.d_model,), dtype=dt),
    }


def mlp(cfg: ModelConfig, p, x):
    # jax.nn.gelu defaults to the tanh approximation.
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if cfg.mlp_type == "geglu":
        return (F.gelu(x @ p["wg"], approximate="tanh")
                * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["wu"] + p["bu"], approximate="tanh") @ p["wd"] \
        + p["bd"]


# ------------------------------------------------------------------- moe ---

def init_moe(cfg: ModelConfig, gen):
    """Router (float32 under any model dtype), stacked expert weights
    [E, ...] and, where the config has them, the shared experts as one
    wider MLP.  Draw order: router, wg, wu, wd, shared."""
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = _dtype(cfg)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": _normal(gen, (d, E), s_in, torch.float32),
        "wg": _normal(gen, (E, d, ff), s_in, dt),
        "wu": _normal(gen, (E, d, ff), s_in, dt),
        "wd": _normal(gen, (E, ff, d), s_out, dt),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(cfg, gen, d_ff=ff * m.num_shared_experts)
    return p


def moe_router(cfg: ModelConfig, p, xf):
    """Top-k routing in float32.  xf [N, D] -> (weights [N, k] renormalised
    over the k, expert ids [N, k] by falling probability, Switch-style
    load-balance aux loss)."""
    m = cfg.moe
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)      # [N, E]
    w, ids = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    E = m.num_experts
    me = probs.mean(dim=0)                                   # mean prob/expert
    ce = F.one_hot(ids[:, 0], E).float().mean(dim=0)         # top-1 share
    aux = E * torch.sum(me * ce) * m.load_balance_coef
    return w, ids, aux


def _swiglu(x, wg, wu, wd, dtype):
    return (F.silu(x @ wg) * (x @ wu)).to(dtype) @ wd


def moe_gmm(cfg: ModelConfig, p, x):
    """Dropless MoE: the k (token, expert) pairs of every token sorted by
    expert (a stable sort, as ``jnp.argsort``), each expert's contiguous
    rows through its SwiGLU by ``torch.matmul`` (JAX's ``lax.ragged_dot``),
    empty experts skipped.  The group sizes come to the host: one sync a
    call.  x [B, T, D] -> (y [B, T, D], aux)."""
    m = cfg.moe
    B, T, D = x.shape
    N, k = B * T, m.top_k
    xf = x.reshape(N, D)
    w, ids, aux = moe_router(cfg, p, xf)

    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)                 # [N*k]
    xs = xf[order // k]                                      # source token
    # each expert's first row in the sorted order (no device sync until
    # the one copy to the host)
    bounds = torch.searchsorted(flat[order], torch.arange(
        m.num_experts + 1, device=x.device)).tolist()
    wg, wu, wd = (p[n].unbind(0) for n in ("wg", "wu", "wd"))
    ys = [_swiglu(xs[a:b], wg[e], wu[e], wd[e], x.dtype)
          for e, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])) if b > a]
    y = torch.cat(ys) * w.reshape(-1)[order].to(x.dtype)[:, None]

    # JAX scatters y into zeros of y's dtype (``.at[tok].add``): each
    # token's k contributions are added in sorted order, i.e. by ascending
    # expert id, each sum rounded to the dtype.  Gather them back in that
    # order and add one at a time.
    slot = torch.empty_like(order)
    slot[order] = torch.arange(N * k, device=x.device)
    c = y[slot.view(N, k).sort(dim=1).values]                # [N, k, D]
    out = c[:, 0]
    for j in range(1, k):
        out = out + c[:, j]

    if m.num_shared_experts:
        out = out + mlp(cfg, p["shared"], xf)
    return out.reshape(B, T, D), aux


def moe_dense(cfg: ModelConfig, p, x):
    """All-experts formulation: every token through every expert, combined
    by the routing weights (E/k x the operations of :func:`moe_gmm`)."""
    m = cfg.moe
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    w, ids, aux = moe_router(cfg, p, xf)
    mask = F.one_hot(ids, m.num_experts).float()                  # [N,k,E]
    comb = torch.einsum("nk,nke->ne", w, mask).to(x.dtype)        # [N,E]

    g = torch.einsum("nd,edf->enf", xf, p["wg"])
    u = torch.einsum("nd,edf->enf", xf, p["wu"])
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.einsum("enf,efd->end", h, p["wd"])                  # [E,N,D]
    out = torch.einsum("end,ne->nd", y, comb)

    if m.num_shared_experts:
        out = out + mlp(cfg, p["shared"], xf)
    return out.reshape(B, T, D), aux
