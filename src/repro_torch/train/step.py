"""Training step: loss, gradients, AdamW update (the port of
``repro/train/step.py``).

``make_train_step`` returns a plain function of (state, batch): the loss
and its gradients come from ``torch.autograd.grad`` over the parameter
leaves, then :func:`~repro_torch.optim.adamw_update` builds the new state.
Gradient accumulation over microbatches is a Python loop (JAX's
``lax.scan``) with float32 accumulators, as JAX's; ``grad_acc_specs``
places the accumulator by its specs on the ambient mesh (JAX's
``with_sharding_constraint``), which changes no number.

A state placed on a mesh (DTensor leaves, :func:`place_state`) takes the
partitioned step, what GSPMD makes of JAX's step jitted with the state's
shardings, for every family: each rank keeps only its blocks of the
parameters (``param_specs``) and of the AdamW moments (``zero_specs``:
ZeRO-1, also cut over 'data'), computes the gradients of its block of the
batch (``batch_spec``) with its share of every product (the model's
tensor-parallel regions, ``distributed.sharding.partitioned``: megatron's
column and row blocks of the attention, the MLPs, rwkv6's time and
channel mixes and the RG-LRU block, the vocabulary cut over 'model', and
the MoE's E / model experts of ``moe/w[gud]`` beside the replicated
router), averages them over the data axes, clips by the norm over the
blocks, and updates its blocks, each cut to the moments' data share and
gathered back over 'data'.  Between the regions the residual stream is
the rank's block of the sequence where JAX's ``residual_shard`` cuts it
(``seq_parallel``, the model axis dividing T: megatron's sequence
parallelism, an all-gather over T into each region and a reduce-scatter
out of it, so the blocks' saved inputs are 1 / model a rank; whisper's
encoder and decoder each by its own length), whole on every model rank
elsewhere; attention runs context-parallel where JAX's ``_cp_shard``
does (the heads not dividing the model axis, or ``cp_attention``: each
rank every head on its block of the queries; whisper's cross-attention
too).  Both cut only over 'model', inside the model (``models/``), so the
batch's rows and the data mean are as without them.  At model 1 and one
data rank the numbers are one card's bit for bit; over several ranks the
row products' and the experts' sums, the data mean and the sequence
blocks' reductions change the float32 round-off.  A mesh without a
'model' axis (the dry run's ``dp_only``) runs the same step with no
region: each rank the whole model on its rows.

The MoE runs in the step as ``moe_impl`` names it, on the rank's blocks:
``gmm`` the pairs routed to the rank's experts, ``dense`` the rank's
experts on every token, their outputs summed over 'model'; ``a2a`` its
block of the batch cut by sequence over 'model' and exchanged with the
rank's experts by all-to-alls (``distributed/moe_a2a.py``).  The
load-balancing term is computed alike on every model rank (the a2a's:
the mean of the ranks' local estimates) and counts 1 / n a data rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..api.scenario import resolve_device
from ..distributed import sharding
from ..kernels.flash_attention.ops import check_executor
from ..models import EXTRA_KEYS, ModelBundle, logits_width
from ..optim import (AdamWConfig, OptState, adamw_init, adamw_update,
                     global_norm)
from ..tree import leaves, tree_map, unflatten_like


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor           # int32 scalar on the parameters' device


def init_train_state(bundle: ModelBundle, seed: int = 0, *, device=None,
                     mesh=None) -> TrainState:
    """Fresh parameters, drawn on ``device`` by a ``torch.Generator`` there
    seeded with ``seed``, zero Adam moments and step 0.  With ``mesh``,
    the state :func:`place_state` would make of it, from the same draws,
    the rank keeping only its blocks: every family's leaves are cut as
    they are drawn (a stacked one layer by layer, a list's layer by
    layer), so the peak is one leaf or layer beside the blocks, and the
    moments are made at their blocks' shapes (``zero_specs``)."""
    from torch.distributed.tensor import DTensor

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        params = bundle.init_params(gen, device=dev)
        opt = adamw_init(params)
        return TrainState(params=params, opt=opt,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=opt.count.device))
    shapes = bundle.init_params(0, device="meta")
    pspecs = sharding.param_specs(
        shapes, model_divisor=sharding.mesh_shape(mesh).get("model", 1))
    zspecs = sharding.zero_specs(pspecs, shapes, mesh)

    def keep(path, x, stacked=False):
        spec = sharding._at(pspecs, path)
        spec = sharding.P(*tuple(spec)[1:]) if stacked else spec
        return sharding.local_block(x, mesh, spec).clone()
    params = bundle.init_params(gen, device=dev, cut=keep)

    def placed(local, specs):
        return sharding._map_with_path(
            lambda path, x: DTensor.from_local(
                x, mesh, sharding._placements(mesh, sharding._at(specs,
                                                                 path)),
                run_check=False, shape=sharding._at(shapes, path).shape,
                stride=sharding._at(shapes, path).stride()), local)

    def zeros():
        return sharding._map_with_path(lambda path, m: torch.zeros(
            sharding.local_block(m, mesh, sharding._at(zspecs, path)).shape,
            dtype=torch.float32, device=dev), shapes)
    return TrainState(
        params=placed(params, pspecs),
        opt=OptState(mu=placed(zeros(), zspecs), nu=placed(zeros(), zspecs),
                     count=torch.zeros((), dtype=torch.int32, device=dev)),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def _ce_chunk(lg, lb, model=None):
    lf = lg.to(torch.float32)
    if model is None:
        logz = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, lb.clamp_min(0).long()[..., None])[..., 0]
    else:
        # the vocabulary cut over the model axis: this rank holds its
        # block of V / size logits; the max, the sum of exponentials and
        # the gold logit (from the rank that holds it) reduced over the axis
        n = lf.shape[-1]
        m = sharding.max_over_model(lf.amax(dim=-1), model)
        s = torch.sum(torch.exp(lf - m[..., None]), dim=-1)
        logz = m + torch.log(sharding.reduce_from_model(s, model))
        t = lb.long() - model.rank * n
        inside = (t >= 0) & (t < n)
        gold = lf.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
        gold = sharding.reduce_from_model(
            gold.masked_fill(~inside, 0.0), model)
    nll = logz - gold
    mask = (lb >= 0).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits, labels, chunk: int = 512, model=None):
    """Mean token CE in float32; labels < 0 are masked.

    The sequence is processed in chunks of ``chunk`` positions (the last
    takes the remainder), each checkpointed under autograd, so the float32
    upcast of [B, T, V] never exists whole.  JAX selects the gold logit with
    an iota == label mask and a sum (for its sharded vocabulary); a
    ``gather`` gives the same value.  ``model`` (a
    ``sharding.ModelAxis``): ``logits`` are this rank's block of a
    vocabulary cut over it, rank by rank, and the reductions run over
    the axis (every rank gets the whole CE)."""
    T = logits.shape[1]
    n = max(T // chunk, 1)
    csize = T // n
    sizes = [csize] * (n - 1) + [T - csize * (n - 1)]
    remat = torch.is_grad_enabled() and logits.requires_grad
    tot = torch.zeros((), dtype=torch.float32, device=logits.device)
    cnt = torch.zeros((), dtype=torch.float32, device=logits.device)
    # one split: its backward concatenates the chunks' gradients
    for lg, lb in zip(logits.split(sizes, dim=1), labels.split(sizes, dim=1)):
        s, c = (checkpoint(_ce_chunk, lg, lb, model, use_reentrant=False)
                if remat else _ce_chunk(lg, lb, model))
        tot, cnt = tot + s, cnt + c
    return torch.div(tot, torch.clamp_min(cnt, 1.0))


def make_loss_fn(bundle: ModelBundle, moe_impl: str = "gmm", *,
                 executor: str = "auto"):
    def loss_fn(params, batch):
        kw = {k: batch[k] for k in EXTRA_KEYS if k in batch}
        logits, _, aux = bundle.forward(params, batch["tokens"],
                                        moe_impl=moe_impl, executor=executor,
                                        **kw)
        # the rank's block of a vocabulary cut over the axis, told from
        # the whole logits by their width (whisper's is padded)
        ax = sharding.model_axis()
        cut = ax is not None and logits.shape[-1] != logits_width(bundle.cfg)
        ce = cross_entropy(logits, batch["labels"], model=ax if cut else None)
        return ce + aux, (ce, aux)
    return loss_fn


def loss_and_grads(loss_fn, params, batch, ce_weight=None):
    """(loss, ce, aux, grads) of ``loss_fn`` (:func:`make_loss_fn`) at
    ``params``: the gradients by ``torch.autograd.grad`` over the leaves,
    as a tree like ``params`` (JAX's ``value_and_grad``).  ``ce_weight``
    (a data rank's, :func:`_data_mean`): the loss differentiated, and the
    loss and ce returned, are those of ``ce * ce_weight + aux``."""
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, (ce, aux) = loss_fn(unflatten_like(params, req), batch)
        if ce_weight is not None:
            ce = ce * ce_weight
            loss = ce + aux
        grads = torch.autograd.grad(loss, req)
    return (loss.detach(), ce.detach(), aux.detach(),
            unflatten_like(params, grads))


def place_state(state: TrainState, mesh) -> TrainState:
    """``state`` with its parameters placed on ``mesh`` by ``shardings(mesh,
    param_specs(..., model_divisor=<the mesh's model size>))`` and its
    AdamW moments by ``zero_specs`` of those (ZeRO-1: also cut over
    'data', as JAX's dry run places them); the count and step as they
    are."""
    pspecs = sharding.param_specs(
        state.params, model_divisor=sharding.mesh_shape(mesh).get("model", 1))
    zl = sharding.shardings(mesh, sharding.zero_specs(pspecs, state.params,
                                                      mesh))
    return TrainState(
        params=sharding.place_tree(state.params, mesh,
                                   sharding.shardings(mesh, pspecs)),
        opt=OptState(mu=sharding.place_tree(state.opt.mu, mesh, zl),
                     nu=sharding.place_tree(state.opt.nu, mesh, zl),
                     count=state.opt.count),
        step=state.step)


def _data_mean(mesh):
    """None at one data rank; else (weight, mean) over the mesh's n data
    ranks: ``weight(labels)`` is this rank's CE weight c n / total, c its
    unmasked labels of the (micro)batch and total the ranks' sum, so that
    the plain mean of the weighted CEs is the global batch's mean CE as in
    JAX (1 where every rank has as many); ``mean(xs)`` averages a list of
    tensors over the ranks, so the MoE's load-balancing term and its
    gradient are the mean of the ranks' (1 / n each, whatever they
    mask)."""
    axes = sharding.data_axes(mesh)
    n = sharding.axis_size(mesh, axes)
    if n == 1:
        return None
    group = sharding.axis_group(mesh, axes)

    def weight(labels):
        c = torch.sum(labels >= 0).to(torch.float32)
        total = c.clone()
        torch.distributed.all_reduce(total, group=group)
        return torch.div(c * n, torch.clamp_min(total, 1.0))

    def mean(xs):
        out = []
        for x in xs:
            x = x.clone()
            torch.distributed.all_reduce(x, group=group)
            out.append(torch.div(x, n))
        return out
    return weight, mean


def _batch_block(batch, mesh):
    """This rank's rows of the global ``batch`` (``batch_spec``; M-RoPE's
    positions [3, B, S] by their dim 1)."""
    dp = sharding.data_axes(mesh)
    return {k: sharding.local_block(
        v, mesh, sharding.P(None, dp) if k == "mrope_pos" else
        sharding.batch_spec(mesh)) for k, v in batch.items()}


def _cut_on(x, axis: str):
    """The dim a placed leaf is cut on over the mesh axis ``axis`` (of more
    than one rank), or None."""
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    if axis not in names or sharding.mesh_shape(x.device_mesh)[axis] == 1:
        return None
    pl = x.placements[names.index(axis)]
    return pl.dim if isinstance(pl, Shard) else None


def _update_blocks(opt_cfg: AdamWConfig, grads, state: TrainState, mesh):
    """AdamW on this rank's blocks (``grads``: the gradients of its blocks
    of ``state.params``, averaged over the data axes): the clip by the norm
    over the blocks, each block cut to its moments' share over 'data'
    (ZeRO-1) for the update and the new shares gathered back over 'data'.
    Returns the new placed parameters and moments and the metrics."""
    from torch.distributed.tensor import DTensor

    def local(tree):
        return tree_map(lambda x: x.to_local(), tree)

    pl, ml = leaves(state.params), leaves(state.opt.mu)
    model = sharding.mesh_shape(mesh).get("model", 1) > 1
    gn = global_norm(grads, cut=[_cut_on(x, "model") is not None
                                 for x in pl] if model else None,
                     group=sharding.axis_group(mesh, "model") if model
                     else None)
    dims = [_cut_on(m, "data") for m in ml]

    def data_share(tree):
        return unflatten_like(tree, [
            x if d is None else sharding.local_block(
                x, mesh, sharding.P(*(None,) * d, "data"))
            for x, d in zip(leaves(tree), dims)])
    params = local(state.params)
    new_p, new_opt, om = adamw_update(
        opt_cfg, data_share(grads),
        OptState(local(state.opt.mu), local(state.opt.nu), state.opt.count),
        data_share(params), grad_norm=gn)
    new_p = [x if d is None else sharding._gather_global(
        x, y.to_local().shape, mesh, sharding.P(*(None,) * d, "data"))
        for x, d, y in zip(leaves(new_p), dims, pl)]

    def placed_like(values, like):
        return unflatten_like(like, [
            DTensor.from_local(x, y.device_mesh, y.placements,
                               run_check=False, shape=y.shape,
                               stride=y.stride())
            for x, y in zip(values, leaves(like))])
    return (placed_like(new_p, state.params),
            OptState(placed_like(leaves(new_opt.mu), state.opt.mu),
                     placed_like(leaves(new_opt.nu), state.opt.nu),
                     new_opt.count), om)


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig, *,
                    moe_impl: str = "gmm", microbatches: int = 1,
                    grad_acc_specs=None, executor: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches > 1`` accumulates float32 gradients over equal splits of
    the batch's leading dim, then scales by 1/m (JAX's step.py:95-122).
    ``grad_acc_specs``: optional spec tree for the float32 accumulator,
    placed by it on the ambient mesh (``sharding.set_mesh``); the
    partitioned step accumulates its blocks as they are.  A state placed
    on a mesh takes the partitioned step (module docstring), with the
    global ``batch`` (every rank the same).  ``executor`` picks the
    flash-attention sites' implementation, forward and backward (``auto``:
    the kernels on a card, the plain versions on the CPU; ``reference``:
    the plain versions anywhere)."""
    check_executor(executor)
    loss_fn = make_loss_fn(bundle, moe_impl, executor=executor)

    def _constrain(tree):
        if grad_acc_specs is None:
            return tree
        mesh = sharding.get_abstract_mesh()
        if mesh.empty:
            raise ValueError("grad_acc_specs places the accumulator on the "
                             "ambient mesh: run under sharding.set_mesh")
        return sharding.place_tree(tree, mesh,
                                   sharding.shardings(mesh, grad_acc_specs))

    def grads_of(params, batch, data=None, constrain=_constrain,
                 block=lambda mb: mb):
        """(loss, ce, aux, grads) of the global ``batch``: each microbatch
        (JAX's split of the global batch) cut to the rank's rows by
        ``block``, its CE weighted and its values averaged over the data
        ranks by ``data`` (a placed state's :func:`_data_mean`) before they
        are accumulated (in an accumulator placed by ``constrain``)."""
        def grads_reduced(mb):
            if data is None:
                return loss_and_grads(loss_fn, params, mb)
            weight, mean = data
            lo, c, a, g = loss_and_grads(loss_fn, params, mb,
                                         weight(mb["labels"]))
            lo, c, a, *gl = mean([lo, c, a, *leaves(g)])
            return lo, c, a, unflatten_like(g, gl)
        if microbatches == 1:
            return grads_reduced(block(batch))
        m = microbatches

        def split(k, v, i):
            if k == "mrope_pos":        # [3, B, S]: batch is dim 1
                return v.reshape((v.shape[0], m, v.shape[1] // m)
                                 + v.shape[2:])[:, i]
            return v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
        mbs = [block({k: split(k, v, i) for k, v in batch.items()})
               for i in range(m)]
        grads = constrain(tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))
        loss = ce = aux = 0.0
        for mb in mbs:
            lo, c, a, g = grads_reduced(mb)
            grads = tree_map(lambda x, y: x + y.to(torch.float32), grads,
                             constrain(g))
            loss, ce, aux = loss + lo, ce + c, aux + a
        inv = 1.0 / microbatches
        grads = tree_map(lambda g: g * inv, sharding.gather_full(grads))
        return loss * inv, ce * inv, aux * inv, grads

    def partitioned_step(state: TrainState, batch):
        mesh = leaves(state.params)[0].device_mesh
        params = tree_map(lambda x: x.to_local(), state.params)
        with sharding.partitioned(mesh):
            loss, ce, aux, grads = grads_of(
                params, batch, _data_mean(mesh), lambda tree: tree,
                lambda mb: _batch_block(mb, mesh))
        with torch.no_grad():
            new_params, new_opt, om = _update_blocks(opt_cfg, grads, state,
                                                     mesh)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    def train_step(state: TrainState, batch):
        params, opt = state.params, state.opt
        if sharding.is_placed(leaves(params)[0]):
            return partitioned_step(state, batch)
        loss, ce, aux, grads = grads_of(params, batch)
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(opt_cfg, grads, opt,
                                                   params)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
