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

Inside a partitioned train step (``distributed.sharding.partitioned``),
the attention (self and cross), the MLP and the MoE hold this rank's
blocks of their weights by ``param_specs`` and compute its share, as
GSPMD partitions JAX's placed step (rwkv6's mixes and the RG-LRU block
are regions of their own models, built of the helpers here): column
blocks of ``wq``/``wk``/``wv`` (and their biases) give
the rank's query heads and the key-value heads they use, ``wg``/``wu`` its
columns of the hidden layer, and the row products with ``wo`` and ``wd``
are summed over the model axis; the MoE's ``w[gud]`` blocks are its E /
model experts, whose outputs are summed over the axis, beside a router
every rank runs alike.  A leaf the specs leave whole (a dim the axis does
not divide) enters the region whole and is cut there (whole and block
told apart by the dim's full size); a block that is not the heads the
rank needs (heads cut below a head, or query heads that do not divide
the axis) is gathered first.  Outside one, or at model 1, nothing here
changes.

Two of JAX's sharding constraints change what a rank computes there, and
the port runs them as GSPMD does:
  * sequence parallelism (``seq``; JAX's ``residual_shard`` where
    :func:`sequence_parallel` holds, decided by ``models/lm.py``): the
    residual stream between the regions is the rank's [B, T / model, D]
    block, so each region takes its input in by an all-gather over T
    (``gather_from_sequence``, in place of ``copy_to_model``) and leaves
    by a reduce-scatter (``scatter_to_sequence``, in place of
    ``reduce_from_model``); the norms run on the block;
  * context-parallel attention (JAX's ``_cp_shard``, where
    :func:`context_parallel` holds): the rank computes every head for its
    block of the queries, at query offset rank x T / model in kernels 2
    and 3, against K and V gathered over T (non-causal: full scores;
    cross-attention: K and V of the whole encoder output, which the
    caller brought into the region once).
``logits_shard`` is the vocabulary-cut logits of a partitioned step
(``models/lm.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..distributed.sharding import (copy_to_model, gather_from_model,
                                    gather_from_sequence, gather_out_of_model,
                                    model_axis, reduce_from_model,
                                    replicated_from_model,
                                    scatter_to_sequence, sequence_block)
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ops import gqa_kv
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


#: The products ``remat_save="dots"`` keeps: matrix products without batch
#: dimensions (JAX's ``dots_with_no_batch_dims_saveable``); ``x @ w`` of
#: [B, T, D] by [D, F] folds into one of them, a batched ``bmm`` (the
#: attention scores and the dense MoE's expert products) is recomputed.
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(cfg: ModelConfig):
    """What a rematerialised block keeps for the backward (JAX's
    layers.py:63-70), as ``torch.utils.checkpoint``'s ``context_fn``.
    ``'nothing'`` recomputes the whole block and keeps only its inputs (the
    default context).  ``'dots'`` also keeps the outputs of the products in
    :data:`SAVED_DOTS` and recomputes everything else (a selective
    checkpoint): the same gradients, fewer operations in the backward and
    more memory held."""
    if getattr(cfg, "remat_save", "nothing") == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
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


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6, *, seq=False):
    """The config's norm of ``x``; ``seq``: x is the rank's sequence block
    of a partitioned step, whose share of the parameters' gradient the
    parameters, entering the region, sum over the model axis."""
    if seq:
        ax = model_axis()
        p = {k: copy_to_model(v, ax) for k, v in p.items()}
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


def sequence_parallel(cfg: ModelConfig, ax, T: int) -> bool:
    """Whether a forward without a cache cuts its residual stream of
    length ``T`` by sequence over the model axis ``ax`` (JAX's
    ``residual_shard``, models/layers.py:73-87): ``cfg.seq_parallel``, an
    axis of more than one rank (``ax`` not None), and T divisible by it."""
    return bool(cfg.seq_parallel) and ax is not None and T % ax.size == 0


def context_parallel(cfg: ModelConfig, mp: int, T: int) -> bool:
    """JAX's condition for context-parallel attention over a model axis
    of ``mp`` ranks (models/layers.py:384-399): mp > 1, T divisible by it,
    and heads that it does not divide, or ``cfg.cp_attention``.  JAX also
    asks Tq > q_chunk, which only picks its chunked branch over full
    scores; the port's kernel computes both branches, so the condition
    is left out."""
    return (mp > 1 and T % mp == 0
            and (cfg.num_heads % mp != 0
                 or bool(getattr(cfg, "cp_attention", False))))


def local_heads(cfg: ModelConfig, ax) -> tuple:
    """(first query head, query heads, first key-value head, key-value
    heads) this rank computes on the model axis ``ax``: its H / size
    query heads where the axis divides H (every head where it does not,
    or without an axis: on a partitioned path only where T does not
    divide either, as context-parallel attention takes the rest), and
    the key-value heads those use (head h uses h // (H / Hkv))."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if ax is None or H % ax.size:
        return 0, H, 0, Hkv
    n = H // ax.size
    g = H // Hkv
    q0 = ax.rank * n
    return q0, n, q0 // g, (q0 + n - 1) // g + 1 - q0 // g


def _share(w, ax, dim: int, full: int):
    """This rank's share of ``w`` along ``dim`` (``full`` long whole): the
    leaf as it is where the rank holds its block there, else (the specs
    left it whole) the rank's chunk of it, the leaf entering the region;
    ``w`` itself without an axis."""
    if ax is None or w.shape[dim] != full:
        return w
    a, b = full * ax.rank // ax.size, full * (ax.rank + 1) // ax.size
    return copy_to_model(w, ax).narrow(dim, a, b - a)


def _whole(w, ax, dim: int, full: int):
    """The whole of leaf ``w`` (``full`` long along ``dim``) inside a
    region: the leaf entering where the specs left it whole, else the
    ranks' blocks gathered (either way its gradient, the rank's share,
    summed over the axis); ``w`` itself without an axis."""
    if ax is None:
        return w
    if w.shape[dim] == full:
        return copy_to_model(w, ax)
    return gather_from_model(w, ax, dim)


def _enter(x, ax, seq: bool, dim: int = 1):
    """A region's input: the replicated stream by ``copy_to_model``, or
    (``seq``) the rank's sequence block gathered along ``dim``."""
    return gather_from_sequence(x, ax, dim) if seq else copy_to_model(x, ax)


def _leave(y, ax, seq: bool, dim: int = 1):
    """A region's partial output: summed over the axis, whole
    (``reduce_from_model``) or (``seq``) the rank's block along ``dim``."""
    return (scatter_to_sequence(y, ax, dim) if seq
            else reduce_from_model(y, ax))


def _rows_out(y, w, ax, full: int, seq: bool):
    """A region's row product ``y @ w`` leaving it (:func:`_leave`) with the
    rank's rows of ``w`` (``full`` rows whole): y's columns are those
    rows, or (each rank computed every head) every row, of which the
    rank's chunk is taken."""
    w = _share(w, ax, 0, full)
    if w.shape[0] != y.shape[-1]:
        a = full * ax.rank // ax.size
        y = y[..., a:a + w.shape[0]]
    return _leave(y @ w, ax, seq)


def _head_cols(w, ax, first: int, n: int, hd: int, total: int):
    """The last-dim columns of heads ``first``..``first + n`` of ``total``
    heads of width ``hd`` from ``w``: whole (entering the region), or this
    rank's block, used as it is where it is exactly those heads and
    gathered from the model axis where it is not; ``w`` itself without an
    axis."""
    if ax is None:
        return w
    lo, hi = first * hd, (first + n) * hd
    cols = w.shape[-1]
    if cols == total * hd:
        return copy_to_model(w, ax)[..., lo:hi]
    if (lo, hi) == (ax.rank * cols, (ax.rank + 1) * cols):
        return w
    return gather_from_model(w, ax)[..., lo:hi]


def _qkv(cfg: ModelConfig, p, x, xkv=None, ax=None, heads=None):
    """q [B,T,H,hd], k/v [B,Tk,Hkv,hd] of ``x`` (inside the region: the
    caller brings it in); with a model axis ``ax``, the heads ``heads`` =
    (first query head, query heads, first key-value head, key-value
    heads), by default the rank's (:func:`local_heads`), from its
    blocks."""
    hd = cfg.resolved_head_dim
    xkv = x if xkv is None else xkv
    q0, nq, k0, nk = heads or local_heads(cfg, ax)
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ _head_cols(p["wq"], ax, q0, nq, hd, H)
    k = xkv @ _head_cols(p["wk"], ax, k0, nk, hd, Hkv)
    v = xkv @ _head_cols(p["wv"], ax, k0, nk, hd, Hkv)
    if "bq" in p:
        q = q + _head_cols(p["bq"], ax, q0, nq, hd, H)
        k = k + _head_cols(p["bk"], ax, k0, nk, hd, Hkv)
        v = v + _head_cols(p["bv"], ax, k0, nk, hd, Hkv)
    B, T = x.shape[:2]
    Tk = xkv.shape[1]
    q = q.reshape(B, T, nq, hd)
    k = k.reshape(B, Tk, nk, hd)
    v = v.reshape(B, Tk, nk, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, copy_to_model(p["q_norm"], ax))
        k = rms_head_norm(k, copy_to_model(p["k_norm"], ax))
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


def _rope(cfg: ModelConfig, q, k, positions, mrope_pos):
    """q and k rotated at ``positions`` [B, T] (``mrope_pos`` [3, B, T]
    under M-RoPE)."""
    hd = cfg.resolved_head_dim
    if cfg.mrope and mrope_pos is not None:
        cos, sin = mrope_cos_sin(mrope_pos, cfg.mrope_sections, hd,
                                 cfg.rope_theta)
    else:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _cp_attention(cfg: ModelConfig, p, x, positions, window, mrope_pos,
                  executor, seq, ax, causal=True, xkv=None, rope=True):
    """Context-parallel attention on the model axis ``ax`` (JAX's
    ``_cp_shard`` route): the rank's block of T / size queries over every
    head, from the whole ``wq`` (its blocks gathered).  Self-attention: K
    and V computed on the block and gathered over T (the small GQA K/V);
    cross-attention (``xkv``, the whole keys' input already inside the
    region): K and V of every key from it through the whole ``wk``/``wv``,
    nothing gathered over T.  Causal attention runs kernels 2 and 3 at
    query offset rank x T / size; non-causal (whisper's encoder and
    cross-attention) full scores without a mask.  The block's output by
    the whole ``wo``: the rank's block of the stream (``seq``) or, without
    sequence parallelism, gathered back into the replicated stream."""
    hd, H, Hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    t0, n = sequence_block(positions.shape[1], ax)
    xb = x if seq else copy_to_model(x, ax).narrow(1, t0, n)
    q, k, v = _qkv(cfg, p, xb, xkv, ax, heads=(0, H, 0, Hkv))
    if xkv is None:
        if rope and cfg.use_rope:
            q, k = _rope(cfg, q, k, positions[:, t0:t0 + n],
                         None if mrope_pos is None else
                         mrope_pos[:, :, t0:t0 + n])
        k, v = gather_from_sequence(k, ax), gather_from_sequence(v, ax)
    if causal:
        y = flash_attention(q, k, v, causal=True, window=window,
                            executor=executor, q_offset=t0)
    else:
        y = attention_scores_full(q, k, v, torch.zeros(
            (1, 1, 1, 1, 1), dtype=torch.float32, device=x.device))
    B = y.shape[0]
    y = y.reshape(B, n, H * hd) @ _whole(p["wo"], ax, 0, H * hd)
    return y if seq else gather_out_of_model(y, ax, 1)


def attention(cfg: ModelConfig, p, x, positions, *, causal=True, window=0,
              cache=None, from_start=False, xkv=None, mrope_pos=None,
              executor="auto", seq=False):
    """Unified attention: forward without a cache, prefill, and decode.

    cache: None -> plain forward over x; a layer cache dict
    (``k``, ``v``, ``idx`` [host int], ``per_row``, optional ``rows``, and
    ``pos`` for a ring) -> write x's k/v at ``idx`` (contiguous), at
    ``idx % len`` (ring) or at ``positions`` (per row) and attend over the
    cache.  ``from_start``: the caller's positions are
    0..T-1 in every row (host knowledge; the forward's default).
    ``xkv`` [B, Tk, D]: keys and values from it (cross-attention, or
    whisper's encoder with xkv = x), without the rotary embedding; in a
    partitioned step an ``xkv`` other than x is already inside the region
    (whisper's encoder output, brought in once for every layer), and
    ``xkv = x`` enters with x, once.
    ``mrope_pos`` [3, B, T]: M-RoPE positions, used when ``cfg.mrope``.
    ``executor`` picks the flash-attention sites' implementation
    (``auto``/``cuda``/``reference``, kernels/flash_attention/ops.py).
    ``seq``: in a partitioned step, x and y are the rank's blocks of the
    sequence-parallel stream (``positions`` whole).
    Returns (y [B,T,D], new_cache_or_None).  Without a cache, causal
    attention over Tq > 1 runs the kernel, which covers both of JAX's
    branches (full scores, and ``attention_chunked`` past ``q_chunk``);
    in a partitioned step where :func:`context_parallel` holds, on the
    rank's block of the queries (:func:`_cp_attention`).
    """
    ax = model_axis()
    if ax is not None and cache is not None:
        raise ValueError("a partitioned step runs attention without a cache")
    rope = xkv is None
    if ax is not None and xkv is x:         # whisper's encoder: self
        xkv = None
    if ax is not None and context_parallel(cfg, ax.size, positions.shape[1]):
        return _cp_attention(cfg, p, x, positions, window, mrope_pos,
                             executor, seq, ax, causal, xkv, rope), None
    q, k, v = _qkv(cfg, p, _enter(x, ax, seq), xkv, ax)
    hd = cfg.resolved_head_dim
    # a rank's query heads and the key-value heads they use (GQA by the
    # global head index), for the kernel's wrapper
    q0, _, k0, _ = local_heads(cfg, ax)
    heads = None if ax is None else (q0, k0,
                                     cfg.num_heads // cfg.num_kv_heads)

    if rope and cfg.use_rope:
        q, k = _rope(cfg, q, k, positions, mrope_pos)

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
                            executor=executor, heads=heads)
    else:
        # One query, or non-causal attention (JAX ignores the window
        # there): full scores, JAX's branch for a short sequence.
        bias = torch.zeros((1, 1, 1, 1, 1), dtype=torch.float32,
                           device=x.device)
        if heads is not None:
            k, v = gqa_kv(k, v, q.shape[2], heads)
        y = attention_scores_full(q, k, v, bias)

    # the row product of the rank's rows of wo, summed over the model axis:
    # its heads' rows, or its chunk of every head's rows where each rank
    # computed every head (the axis divides neither H nor T)
    return _rows_out(y.reshape(B, Tq, q.shape[2] * hd), p["wo"], ax,
                     cfg.num_heads * hd, seq), new_cache


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


def _mlp_rows(cfg: ModelConfig, p, x, F_: int, ax):
    """The MLP's row product of ``x`` (inside the region) before the sum
    over the model axis and ``bd``: the rank's columns of ``wg``/``wu``
    and rows of ``wd`` (whole leaves, ``F_`` wide, cut)."""
    wu, wd = _share(p["wu"], ax, -1, F_), _share(p["wd"], ax, 0, F_)
    # jax.nn.gelu defaults to the tanh approximation.
    if cfg.mlp_type == "gelu":
        h = F.gelu(x @ wu + _share(p["bu"], ax, -1, F_), approximate="tanh")
        return h @ wd
    g = x @ _share(p["wg"], ax, -1, F_)
    g = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(
        g, approximate="tanh")
    return (g * (x @ wu)) @ wd


def mlp(cfg: ModelConfig, p, x, d_ff: Optional[int] = None, seq=False):
    """The block's MLP, ``d_ff`` wide whole (``cfg.d_ff`` by default; the
    MoE's shared experts are ``d_ff_expert * num_shared_experts``); in a
    partitioned step, the rank's columns of ``wg``/``wu`` and rows of
    ``wd`` (told from the whole leaves by that width), the row product
    summed over the model axis, ``bd`` added once after the sum.  ``seq``:
    x and the output are the rank's blocks of the sequence-parallel stream
    along dim -2 (the tokens of [B, T, D] or [N, D])."""
    ax = model_axis()
    F_ = d_ff or cfg.d_ff
    y = _leave(_mlp_rows(cfg, p, _enter(x, ax, seq, -2), F_, ax), ax, seq,
               -2)
    if cfg.mlp_type == "gelu":
        y = y + (copy_to_model(p["bd"], ax) if seq else p["bd"])
    return y


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
    ce = _one_hot(ids[:, 0], E).mean(dim=0)                  # top-1 share
    aux = E * torch.sum(me * ce) * m.load_balance_coef
    return w, ids, aux


def _one_hot(ids, n: int):
    """float32 one-hot of ``ids`` over ``n`` classes (``F.one_hot``'s
    values, without the range check it runs on CPU tensors: a host read
    the card and ``meta`` do not make)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(
        torch.float32)


def _expert_block(E: int, ax) -> tuple:
    """(first, end) of the experts this rank runs on the model axis ``ax``
    (its block of ``moe/w[gud]`` by ``param_specs``, or its chunk of a
    leaf the specs leave whole); every expert without an axis."""
    if ax is None:
        return 0, E
    return E * ax.rank // ax.size, E * (ax.rank + 1) // ax.size


def shared_experts(cfg: ModelConfig, p, xf, seq=False):
    """The shared experts' output for the tokens ``xf`` [N, D]: one MLP
    of them all, ``d_ff_expert * num_shared_experts`` wide whole (``seq``:
    :func:`mlp`'s)."""
    m = cfg.moe
    return mlp(cfg, p["shared"], xf, m.d_ff_expert * m.num_shared_experts,
               seq)


def _moe_tokens(x, ax, seq: bool):
    """(the tokens [N, D] the router runs on, the same tokens inside the
    region) of a MoE layer's input ``x``: the replicated tokens, entering
    by ``copy_to_model``; or (``seq``) the rank's sequence block gathered
    over T, which the router, run alike on every rank, sees as a
    replicated value (``replicated_from_model``: each rank's gradient a
    1 / size share, which the gather's reduce-scatter sums)."""
    D = x.shape[-1]
    if seq:
        xin = gather_from_sequence(x, ax).reshape(-1, D)
        return replicated_from_model(xin, ax), xin
    xf = x.reshape(-1, D)
    return xf, copy_to_model(xf, ax)


def _moe_out(cfg: ModelConfig, p, out, xin, x, ax, seq: bool):
    """A MoE layer's output [B, T, D] (the rank's block under ``seq``) from
    the rank's partial expert sums ``out`` [N, D] and, where the config has
    them, the shared experts' row product of ``xin``, summed over the
    model axis together."""
    m = cfg.moe
    if m.num_shared_experts:
        out = out + _mlp_rows(cfg, p["shared"], xin,
                              m.d_ff_expert * m.num_shared_experts, ax)
    B, T = x.shape[0], out.shape[0] // x.shape[0]
    return _leave(out.reshape(B, T, -1), ax, seq)


def _swiglu(x, wg, wu, wd, dtype):
    return (F.silu(x @ wg) * (x @ wu)).to(dtype) @ wd


def moe_gmm(cfg: ModelConfig, p, x, seq=False):
    """Dropless MoE: the k (token, expert) pairs of every token sorted by
    expert (a stable sort, as ``jnp.argsort``), each expert's contiguous
    rows through its SwiGLU by ``torch.matmul`` (JAX's ``lax.ragged_dot``),
    empty experts skipped.  The group sizes come to the host: one sync a
    call.  x [B, T, D] -> (y [B, T, D], aux).

    In a partitioned step the router runs on the replicated tokens on
    every rank alike (its load-balancing term too, whose gradient is
    not summed over the axis); only the pairs of the rank's experts
    (:func:`_expert_block`) run, their tokens and routing weights entering
    the region (:func:`~repro_torch.distributed.sharding.copy_to_model`:
    their gradients summed over the axis; ``seq``: :func:`_moe_tokens`),
    and each token's partial sum over them, with the shared experts',
    leaves summed over the axis (:func:`_moe_out`)."""
    m = cfg.moe
    ax = model_axis()
    xr, xin = _moe_tokens(x, ax, seq)
    N, D = xin.shape
    k, E = m.top_k, m.num_experts
    w, ids, aux = moe_router(cfg, p, xr)
    e0, e1 = _expert_block(E, ax)

    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)                 # [N*k]
    # each expert's first row in the sorted order (no device sync until
    # the one copy to the host)
    bounds = torch.searchsorted(flat[order], torch.arange(
        E + 1, device=x.device)).tolist()
    a, b = bounds[e0], bounds[e1]
    mine = order[a:b]                                        # the rank's pairs
    xs = xin[mine // k]                                      # source token
    wg, wu, wd = (_share(p[n], ax, 0, E).unbind(0) for n in ("wg", "wu",
                                                             "wd"))
    ys = [_swiglu(xs[lo - a:hi - a], wg[e - e0], wu[e - e0], wd[e - e0],
                  x.dtype)
          for e, lo, hi in zip(range(e0, e1), bounds[e0:e1],
                               bounds[e0 + 1:e1 + 1]) if hi > lo]
    if not ys:        # no pair of the rank's experts: none contributes
        ys = [_swiglu(xs, wg[0], wu[0], wd[0], x.dtype)]
    wr = copy_to_model(w, ax).reshape(-1)[mine].to(x.dtype)
    y = torch.cat(ys) * wr[:, None]
    if (a, b) != (0, N * k):          # the other ranks' pairs add zeros
        y = F.pad(y, (0, 0, a, N * k - b))

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
    return _moe_out(cfg, p, out, xin, x, ax, seq), aux


def moe_dense(cfg: ModelConfig, p, x, seq=False):
    """All-experts formulation: every token through every expert, combined
    by the routing weights (E/k x the operations of :func:`moe_gmm`).  In
    a partitioned step (what GSPMD makes of JAX's placed ``moe_dense``)
    the router runs alike on every rank, the rank's experts on every
    token, the combine weights of those experts entering the region, and
    the partial combine leaves summed over the axis (``seq``:
    :func:`moe_gmm`'s)."""
    m = cfg.moe
    ax = model_axis()
    E = m.num_experts
    xr, xin = _moe_tokens(x, ax, seq)
    w, ids, aux = moe_router(cfg, p, xr)
    mask = _one_hot(ids, E)                                       # [N,k,E]
    comb = torch.einsum("nk,nke->ne", w, mask).to(x.dtype)        # [N,E]
    comb = _share(comb, ax, 1, E)             # the rank's experts' columns

    g = torch.einsum("nd,edf->enf", xin, _share(p["wg"], ax, 0, E))
    u = torch.einsum("nd,edf->enf", xin, _share(p["wu"], ax, 0, E))
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.einsum("enf,efd->end", h, _share(p["wd"], ax, 0, E))  # [E,N,D]
    out = torch.einsum("end,ne->nd", y, comb)
    return _moe_out(cfg, p, out, xin, x, ax, seq), aux
