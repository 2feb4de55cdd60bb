"""Training step: loss, gradients, AdamW update (the port of
``repro/train/step.py``).

``make_train_step`` returns a plain function of (state, batch): the loss
and its gradients come from ``torch.autograd.grad`` over the parameter
leaves, then :func:`~repro_torch.optim.adamw_update` builds the new state.
Gradient accumulation over microbatches is a Python loop (JAX's
``lax.scan``) with float32 accumulators, as JAX's; ``grad_acc_specs``
places the accumulator by its specs on the ambient mesh (JAX's
``with_sharding_constraint``), which changes no number.

A state placed on a mesh (DTensor leaves, ``distributed.sharding.
place_tree``) takes the data-parallel step: each leaf is gathered whole
where the model uses it, the rank computes the gradients of its block of
the batch (``batch_spec``), they are averaged over the data axes, every
rank applies the same update to the whole leaves and keeps its blocks.
The model axis computes redundantly (a per-layer gather and true
tensor-parallel products are later work), so the numbers are one card's:
bit for bit at one data rank, to the order of the mean over several.
An MoE model under ``moe_impl="a2a"`` runs the whole batch on every rank
instead: ``moe_a2a``'s ``shard_map`` takes global arrays and cuts the
tokens over the data axes itself, and its gradients come out global (the
same on every rank), so nothing is averaged after.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..api.scenario import resolve_device
from ..distributed import sharding
from ..kernels.flash_attention.ops import check_executor
from ..models import EXTRA_KEYS, ModelBundle
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..tree import leaves, tree_map, unflatten_like


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor           # int32 scalar on the parameters' device


def init_train_state(bundle: ModelBundle, seed: int = 0, *, device=None
                     ) -> TrainState:
    """Fresh parameters, drawn on ``device`` by a ``torch.Generator`` there
    seeded with ``seed``, zero Adam moments and step 0."""
    dev = resolve_device(device)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed),
                                device=dev)
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device))


def _ce_chunk(lg, lb):
    lf = lg.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, lb.clamp_min(0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (lb >= 0).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits, labels, chunk: int = 512):
    """Mean token CE in float32; labels < 0 are masked.

    The sequence is processed in chunks of ``chunk`` positions (the last
    takes the remainder), each checkpointed under autograd, so the float32
    upcast of [B, T, V] never exists whole.  JAX selects the gold logit with
    an iota == label mask and a sum (for its sharded vocabulary); on one
    card a ``gather`` gives the same value."""
    T = logits.shape[1]
    n = max(T // chunk, 1)
    csize = T // n
    sizes = [csize] * (n - 1) + [T - csize * (n - 1)]
    remat = torch.is_grad_enabled() and logits.requires_grad
    tot = torch.zeros((), dtype=torch.float32, device=logits.device)
    cnt = torch.zeros((), dtype=torch.float32, device=logits.device)
    # one split: its backward concatenates the chunks' gradients
    for lg, lb in zip(logits.split(sizes, dim=1), labels.split(sizes, dim=1)):
        s, c = (checkpoint(_ce_chunk, lg, lb, use_reentrant=False) if remat
                else _ce_chunk(lg, lb))
        tot, cnt = tot + s, cnt + c
    return torch.div(tot, torch.clamp_min(cnt, 1.0))


def make_loss_fn(bundle: ModelBundle, moe_impl: str = "gmm", *,
                 executor: str = "auto"):
    def loss_fn(params, batch):
        kw = {k: batch[k] for k in EXTRA_KEYS if k in batch}
        logits, _, aux = bundle.forward(params, batch["tokens"],
                                        moe_impl=moe_impl, executor=executor,
                                        **kw)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, (ce, aux)
    return loss_fn


def loss_and_grads(loss_fn, params, batch):
    """(loss, ce, aux, grads) of ``loss_fn`` (:func:`make_loss_fn`) at
    ``params``: the gradients by ``torch.autograd.grad`` over the leaves,
    as a tree like ``params`` (JAX's ``value_and_grad``)."""
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, (ce, aux) = loss_fn(unflatten_like(params, req), batch)
        grads = torch.autograd.grad(loss, req)
    return (loss.detach(), ce.detach(), aux.detach(),
            unflatten_like(params, grads))


def place_state(state: TrainState, mesh) -> TrainState:
    """``state`` with its parameters and AdamW moments placed on ``mesh``
    by ``shardings(mesh, param_specs(..., model_divisor=<the mesh's model
    size>))`` (JAX's launcher); the count and step as they are."""
    pspecs = sharding.param_specs(
        state.params, model_divisor=sharding.mesh_shape(mesh).get("model", 1))
    pl = sharding.shardings(mesh, pspecs)
    return TrainState(
        params=sharding.place_tree(state.params, mesh, pl),
        opt=OptState(mu=sharding.place_tree(state.opt.mu, mesh, pl),
                     nu=sharding.place_tree(state.opt.nu, mesh, pl),
                     count=state.opt.count),
        step=state.step)


def _data_mean(mesh):
    """A function averaging a list of tensors over the mesh's data axes
    (an all-reduce each; nothing at one data rank)."""
    axes = sharding.data_axes(mesh)
    n = sharding.axis_size(mesh, axes)
    group = sharding.axis_group(mesh, axes)

    def mean(x):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return torch.div(x, n)
    return lambda xs: xs if n == 1 else [mean(x) for x in xs]


def _batch_block(batch, mesh):
    """This rank's rows of the global ``batch`` (``batch_spec``; M-RoPE's
    positions [3, B, S] by their dim 1)."""
    dp = sharding.data_axes(mesh)
    return {k: sharding.local_block(
        v, mesh, sharding.P(None, dp) if k == "mrope_pos" else
        sharding.batch_spec(mesh)) for k, v in batch.items()}


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig, *,
                    moe_impl: str = "gmm", microbatches: int = 1,
                    grad_acc_specs=None, executor: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches > 1`` accumulates float32 gradients over equal splits of
    the batch's leading dim, then scales by 1/m (JAX's step.py:95-122).
    ``grad_acc_specs``: optional spec tree for the float32 accumulator,
    placed by it on the ambient mesh (``sharding.set_mesh``).  A state
    placed on a mesh takes the data-parallel step (module docstring), with
    the global ``batch`` (every rank the same).  ``executor`` picks the
    flash-attention sites' implementation, forward and backward (``auto``:
    the kernels on a card, the plain versions on the CPU; ``reference``:
    the plain versions anywhere)."""
    check_executor(executor)
    loss_fn = make_loss_fn(bundle, moe_impl, executor=executor)
    # moe_a2a cuts the global batch over the data axes itself
    global_batch = moe_impl == "a2a" and bundle.cfg.moe is not None

    def _constrain(tree):
        if grad_acc_specs is None:
            return tree
        mesh = sharding.get_abstract_mesh()
        if mesh.empty:
            raise ValueError("grad_acc_specs places the accumulator on the "
                             "ambient mesh: run under sharding.set_mesh")
        return sharding.place_tree(tree, mesh,
                                   sharding.shardings(mesh, grad_acc_specs))

    def grads_of(params, batch, reduce):
        """(loss, ce, aux, grads) of ``batch``, each microbatch's passed
        through ``reduce`` (the data-axes mean of a placed state) before
        it is accumulated."""
        if microbatches == 1:
            lo, c, a, g = loss_and_grads(loss_fn, params, batch)
            lo, c, a, *gl = reduce([lo, c, a, *leaves(g)])
            return lo, c, a, unflatten_like(g, gl)
        m = microbatches

        def split(k, v, i):
            if k == "mrope_pos":        # [3, B, S]: batch is dim 1
                return v.reshape((v.shape[0], m, v.shape[1] // m)
                                 + v.shape[2:])[:, i]
            return v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
        mbs = [{k: split(k, v, i) for k, v in batch.items()}
               for i in range(m)]
        grads = _constrain(tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))
        loss = ce = aux = 0.0
        for mb in mbs:
            lo, c, a, g = loss_and_grads(loss_fn, params, mb)
            lo, c, a, *gl = reduce([lo, c, a, *leaves(g)])
            grads = tree_map(lambda x, y: x + y.to(torch.float32), grads,
                             _constrain(unflatten_like(g, gl)))
            loss, ce, aux = loss + lo, ce + c, aux + a
        inv = 1.0 / microbatches
        grads = tree_map(lambda g: g * inv, sharding.gather_full(grads))
        return loss * inv, ce * inv, aux * inv, grads

    def train_step(state: TrainState, batch):
        params, opt, reduce = state.params, state.opt, lambda xs: xs
        placed = sharding.is_placed(leaves(params)[0])
        if placed:
            mesh = leaves(params)[0].device_mesh
            params, opt = sharding.gather_full((params, opt))
            if not global_batch:
                batch, reduce = _batch_block(batch, mesh), _data_mean(mesh)
        loss, ce, aux, grads = grads_of(params, batch, reduce)
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(opt_cfg, grads, opt,
                                                   params)
        if placed:
            new_params, new_opt = sharding.place_like(
                (new_params, new_opt), (state.params, state.opt))
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
