"""Expert-parallel MoE with explicit all-to-all dispatch (the port of
``repro/distributed/moe_a2a.py``).

The ``dense`` MoE computes every expert on every token (E/top_k x wasted
operations); the ``gmm`` one is exact but is not partitioned over experts.
Here the experts are sharded over the mesh's 'model' axis, tokens are
routed with a capacity-bounded dispatch and exchanged with an all-to-all
-- the analogue of the paper's transfer channels (the payload is "the
dataset", expert capacity the per-channel window, and the capacity factor
is tuned like the paper tunes concurrency).

Token layout inside :func:`~.sharding.shard_map`: [B/(pod*data), T/model,
D] -- batch and sequence sharded (the sequence only where the model axis
divides it), so each rank routes only its local tokens and a tight
capacity drops tokens by each rank's own order.

    x_send [E, C, D] --all_to_all--> [E_loc, mp*C, D] --experts-->
           [E_loc, mp*C, D] --all_to_all--> [E, C, D] --combine--> out

The router runs in float32 (``layers.moe_router``), the experts as batched
products over [E_loc, mp*C, D]; the dispatch and the combine are plain
PyTorch, as JAX leaves them to XLA.

Two ways in.  Inside a partitioned train step
(``sharding.partitioned``, what GSPMD makes of JAX's placed step) the
body runs on the rank's own arrays: its block of the batch cut by
sequence over 'model' where T divides (JAX's ``x_spec``), its E/mp
experts (``param_specs``' blocks of ``moe/w[gud]``), the replicated
router entering by ``copy_to_model``, and the two all-to-alls over the
model group.  Under sequence parallelism (``seq``) the input is the
rank's block of the stream already and the output stays one: per layer
and rank only the two all-to-alls of [E, C, D] each way move, besides
the all-reduce of the router's gradient.  Without it, the input is the
replicated stream, cut to the rank's block (entering by
``copy_to_model``), and the output's blocks are put back into the
replicated stream by an all-gather whose gradient is only cut
(``gather_out_of_model``).  The aux is the mean over 'model' of the
ranks' local estimates (JAX's ``pmean``; the step averages it over the
data axes), its gradient 1 / mp a rank.

Outside one (serving, the 1 x 1 mesh), arrays are global
(``sharding.shard_map``): every rank holds all E experts and the whole
[B, T, D] activations, each MoE layer cuts a copy of the rank's E/mp
experts and all-gathers its output over the data and model axes, and
its backward all-reduces and all-gathers every gradient; a world of
one rank (the card) skips all of it: the blocks are the inputs
themselves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models import layers as L
from ..models.common import ModelConfig
from .sharding import (P, all_to_all, all_to_all_model, copy_to_model,
                       gather_out_of_model, get_abstract_mesh, model_axis,
                       partitioned_mesh, pmean, reduce_from_model,
                       replicated_from_model, shard_map)


def _axes():
    m = get_abstract_mesh()
    names = m.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    return m, dp, ("model" if "model" in names else None)


def capacity(n_tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Each expert's slots on a rank: ceil(N k / E x factor), at least 1."""
    return max(int(math.ceil(n_tokens * top_k / num_experts
                             * capacity_factor)), 1)


def dispatch_slots(ids, num_experts: int, cap: int):
    """The capacity-bounded dispatch of routed (token, expert) pairs
    ``ids`` [N, k]: each pair's slot in its expert's buffer, in the order
    of the flattened pairs (``pos``), whether it fits (``keep``, pos <
    cap) and the slot it takes (``slot``: pos, or ``cap`` for an
    overflow).  Returns (flat expert ids, keep, slot).

    ``pos`` is JAX's ``cumsum(one_hot(flat_e)) - 1`` at each pair's expert,
    found by a stable sort instead: a pair's rank among the earlier pairs
    of its expert is its index in the sorted order less its expert's first
    index there (a cumsum down the [N k, E] one-hot's long axis took ~50
    ms a layer on the card at 16,384 tokens)."""
    flat_e = ids.reshape(-1)                                  # [N*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) - first
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    return flat_e, keep, slot


def _experts(cfg: ModelConfig, xf, w, ids, wg, wu, wd, exchange,
             capacity_factor):
    """JAX's body from the routing on: the capacity-bounded dispatch of
    the tokens ``xf`` [N, D] (routed ``w``, ``ids`` [N, k]), the dispatch
    ``exchange`` (all-to-all over the model ranks) to the local experts
    ``wg``/``wu``/``wd`` [E_loc, ...], their products, the return
    exchange and the combine.  Returns out [N, D]."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    N, D = xf.shape
    C = capacity(N, k, E, capacity_factor)
    flat_e, keep, slot = dispatch_slots(ids, E, C)
    tok = torch.arange(N, device=xf.device).repeat_interleave(k)
    send = xf.new_zeros((E, C + 1, D))
    send = send.index_put((flat_e, slot), xf[tok])    # dropped -> slot C
    send = send[:, :C]                                # [E, C, D]

    # dispatch: [E, C, D] -> [E_loc, mp*C, D]
    recv = exchange(send, 0, 1)

    # the local experts
    g = torch.bmm(recv, wg)
    u = torch.bmm(recv, wu)
    h = (F.silu(g) * u).to(xf.dtype)
    y = torch.bmm(h, wd)                              # [E_loc, mp*C, D]

    # return: -> [E, C, D]
    back = exchange(y, 1, 0)

    # combine
    back_p = torch.cat([back, back.new_zeros((E, 1, D))], dim=1)
    gathered = back_p[flat_e, slot]                   # [N*k, D]
    wk = (w.reshape(-1) * keep.to(torch.float32)).to(gathered.dtype)
    return torch.sum((gathered * wk[:, None]).reshape(N, k, D), dim=1)


def moe_a2a(cfg: ModelConfig, p, x, *, capacity_factor: float = 1.25,
            seq: bool = False):
    """Drop-in replacement for ``layers.moe_gmm`` / ``moe_dense`` under a
    mesh.  x [B, T, D] -> (out [B, T, D], aux loss scalar: each rank's
    load-balance estimate, averaged over the mesh).  Inside a partitioned
    step, on the rank's arrays (:func:`_partitioned`; ``seq``: x and out
    are the rank's blocks of the sequence-parallel stream); else on global
    arrays over the ambient mesh, and without a mesh or its 'model' axis,
    ``moe_gmm``."""
    if partitioned_mesh() is not None:
        return _partitioned(cfg, p, x, capacity_factor, seq)
    m, dp, model_ax = _axes()
    moe = cfg.moe
    assert moe is not None
    if model_ax is None or m.empty:
        return L.moe_gmm(cfg, p, x)

    mp = m.shape[model_ax]
    E = moe.num_experts
    assert E % mp == 0, (E, mp)

    B, T, D = x.shape
    t_sharded = (T % mp == 0)
    x_spec = P(dp, model_ax if t_sharded else None, None)

    def body(xl, router, wg, wu, wd):
        Bl, Tl, _ = xl.shape
        xf = xl.reshape(Bl * Tl, D)
        w, ids, aux = L.moe_router(cfg, {"router": router}, xf)
        aux = pmean(aux, dp + (model_ax,))
        out = _experts(cfg, xf, w, ids, wg, wu, wd,
                       lambda v, s, c: all_to_all(v, model_ax, s, c),
                       capacity_factor)
        return out.reshape(Bl, Tl, D), aux

    specs_in = (x_spec, P(None, None), P(model_ax, None, None),
                P(model_ax, None, None), P(model_ax, None, None))
    out, aux = shard_map(body, mesh=m, in_specs=specs_in,
                         out_specs=(x_spec, P()))(
        x, p["router"], p["wg"], p["wu"], p["wd"])

    if moe.num_shared_experts:
        out = out + L.shared_experts(cfg, p, x.reshape(B * T, D)).reshape(
            B, T, D)
    return out, aux


def _partitioned(cfg: ModelConfig, p, x, capacity_factor, seq=False):
    """:func:`moe_a2a` inside a partitioned step: JAX's body on this
    rank's arrays (module docstring).  ``x`` is the rank's block of the
    batch: [B/dp, T/mp, D], its block of the sequence-parallel stream
    (``seq``), or [B/dp, T, D] replicated over 'model'; ``p`` its blocks
    of the MoE's leaves."""
    ax = model_axis()
    mp = 1 if ax is None else ax.size
    E = cfg.moe.num_experts
    assert E % mp == 0, (E, mp)
    B, T, D = x.shape
    # the rank's sequence block (JAX's x_spec): the input itself under
    # sequence parallelism, else cut from the replicated stream
    cut = not seq and mp > 1 and T % mp == 0
    xin = x if seq else copy_to_model(x, ax)
    if cut:
        xin = xin.narrow(1, ax.rank * (T // mp), T // mp)
    Bl, Tl = xin.shape[:2]
    xf = xin.reshape(Bl * Tl, D)
    w, ids, aux = L.moe_router(
        cfg, {"router": copy_to_model(p["router"], ax)}, xf)
    # the mean over 'model': every rank carries the loss whole, so each
    # local estimate's gradient is 1 / mp (reduce_from_model passes the
    # gradient as it is; the router's is then summed by its copy)
    aux = reduce_from_model(aux, ax) / mp
    out = _experts(cfg, xf, w, ids, *(L._share(p[n], ax, 0, E)
                                      for n in ("wg", "wu", "wd")),
                   lambda v, s, c: all_to_all_model(v, ax, s, c),
                   capacity_factor).reshape(Bl, Tl, D)
    # back into the replicated stream: the sequence blocks gathered, or
    # (T not cut) the output every rank computed alike; under sequence
    # parallelism the block stays
    if not seq:
        out = gather_out_of_model(out, ax, 1) if cut else \
            replicated_from_model(out, ax)
    if cfg.moe.num_shared_experts:
        out = out + L.shared_experts(cfg, p, x.reshape(B * T, D),
                                     seq).reshape(B, T, D)
    return out, aux
