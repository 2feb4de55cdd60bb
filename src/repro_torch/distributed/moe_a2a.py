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

Cost at a world of several ranks, until the MoE's partitioned step (ROADMAP
queue 1) hands each rank only its experts: arrays are global
(``sharding.shard_map``), so every rank holds all E experts and the whole
[B, T, D] activations, and expert parallelism saves neither memory nor
communication over ``moe_gmm``.  Each MoE layer cuts a copy of the rank's
E/mp experts, all-gathers its output [B, T, D] over the data and model
axes, and in the backward all-reduces the experts' gradient blocks over
the data axes and all-gathers them (all E, on every rank), all-gathers the
activations' gradient and all-reduces the router's over the whole mesh --
besides the two all-to-alls of [E, C, D] each way.  A world of one rank
(the card) skips all of it: the blocks are the inputs themselves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models import layers as L
from ..models.common import ModelConfig
from .sharding import P, all_to_all, get_abstract_mesh, pmean, shard_map


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


def moe_a2a(cfg: ModelConfig, p, x, *, capacity_factor: float = 1.25):
    """Drop-in replacement for ``layers.moe_gmm`` / ``moe_dense`` under a
    mesh.  x [B, T, D] -> (out [B, T, D], aux loss scalar: each rank's
    load-balance estimate, averaged over the mesh).  Without a mesh or
    its 'model' axis, ``moe_gmm``."""
    m, dp, model_ax = _axes()
    moe = cfg.moe
    assert moe is not None
    if model_ax is None or m.empty:
        return L.moe_gmm(cfg, p, x)

    mp = m.shape[model_ax]
    E, k = moe.num_experts, moe.top_k
    assert E % mp == 0, (E, mp)

    B, T, D = x.shape
    t_sharded = (T % mp == 0)
    x_spec = P(dp, model_ax if t_sharded else None, None)

    def body(xl, router, wg, wu, wd):
        Bl, Tl, _ = xl.shape
        N = Bl * Tl
        xf = xl.reshape(N, D)
        w, ids, aux = L.moe_router(cfg, {"router": router}, xf)
        aux = pmean(aux, dp + (model_ax,))

        C = capacity(N, k, E, capacity_factor)
        flat_e, keep, slot = dispatch_slots(ids, E, C)
        tok = torch.arange(N, device=x.device).repeat_interleave(k)
        send = xl.new_zeros((E, C + 1, D))
        send = send.index_put((flat_e, slot), xf[tok])    # dropped -> slot C
        send = send[:, :C]                                # [E, C, D]

        # dispatch: [E, C, D] -> [E_loc, mp*C, D]
        recv = all_to_all(send, model_ax, split_axis=0, concat_axis=1)

        # the local experts
        g = torch.bmm(recv, wg)
        u = torch.bmm(recv, wu)
        h = (F.silu(g) * u).to(xl.dtype)
        y = torch.bmm(h, wd)                              # [E_loc, mp*C, D]

        # return: -> [E, C, D]
        back = all_to_all(y, model_ax, split_axis=1, concat_axis=0)

        # combine
        back_p = torch.cat([back, back.new_zeros((E, 1, D))], dim=1)
        gathered = back_p[flat_e, slot]                   # [N*k, D]
        wk = (w.reshape(-1) * keep.to(torch.float32)).to(gathered.dtype)
        out = torch.sum((gathered * wk[:, None]).reshape(N, k, D), dim=1)
        return out.reshape(Bl, Tl, D), aux

    specs_in = (x_spec, P(None, None), P(model_ax, None, None),
                P(model_ax, None, None), P(model_ax, None, None))
    out, aux = shard_map(body, mesh=m, in_specs=specs_in,
                         out_specs=(x_spec, P()))(
        x, p["router"], p["wg"], p["wu"], p["wd"])

    if moe.num_shared_experts:
        out = out + L.mlp(cfg, p["shared"], x.reshape(B * T, D)).reshape(
            B, T, D)
    return out, aux
