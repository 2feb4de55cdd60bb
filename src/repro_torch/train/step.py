"""Training step: loss, gradients, AdamW update (the port of
``repro/train/step.py``).

``make_train_step`` returns a plain function of (state, batch): the loss
and its gradients come from ``torch.autograd.grad`` over the parameter
leaves, then :func:`~repro_torch.optim.adamw_update` builds the new state.
Gradient accumulation over microbatches is a Python loop (JAX's
``lax.scan``) with float32 accumulators, as JAX's.  The int8 gradient
compression and the sharded accumulator (``grad_acc_specs``) belong to the
multi-card slice (ROADMAP queue 1, item 9e).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..api.scenario import resolve_device
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


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig, *,
                    moe_impl: str = "gmm", microbatches: int = 1,
                    grad_acc_specs=None, executor: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches > 1`` accumulates float32 gradients over equal splits of
    the batch's leading dim, then scales by 1/m (JAX's step.py:95-122).
    ``executor`` picks the flash-attention sites' implementation, forward
    and backward (``auto``: the kernels on a card, the plain versions on
    the CPU; ``reference``: the plain versions anywhere)."""
    if grad_acc_specs is not None:
        raise NotImplementedError("grad_acc_specs shards the gradient "
                                  "accumulator over a mesh: ROADMAP queue 1, "
                                  "item 9e (multi-card)")
    check_executor(executor)
    loss_fn = make_loss_fn(bundle, moe_impl, executor=executor)

    def train_step(state: TrainState, batch):
        if microbatches == 1:
            loss, ce, aux, grads = loss_and_grads(loss_fn, state.params,
                                                  batch)
        else:
            m = microbatches
            mbs = [{k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(m)]
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             state.params)
            loss = ce = aux = 0.0
            for mb in mbs:
                lo, c, a, g = loss_and_grads(loss_fn, state.params, mb)
                grads = tree_map(lambda x, y: x + y.to(torch.float32), grads,
                                 g)
                loss, ce, aux = loss + lo, ce + c, aux + a
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g * inv, grads)
            loss, ce, aux = loss * inv, ce * inv, aux * inv

        with torch.no_grad():
            new_params, new_opt, om = adamw_update(opt_cfg, grads, state.opt,
                                                   state.params)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
