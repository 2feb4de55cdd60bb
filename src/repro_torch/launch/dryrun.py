"""Dry run: count one rank's step for every (arch x shape x mesh) cell on
``meta`` tensors (the port of ``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for 256 or 512 devices and reads the
executable's cost and memory analyses.  The port's program is eager, so
the dry run runs it: one rank of a world of ``mesh.size`` ranks (a fake
process group: rank 0, collectives that move nothing), every tensor on the
``meta`` device (shapes and types, nothing allocated, no kernel launched),
under a :class:`~repro_torch.launch.hlo_stats.StepCounter` that counts
its FLOPs, bytes, collectives and live memory, the hand-written kernels
by their own formulas.

What is counted is the port's program on one rank.  Every family's train
cells run the partitioned step (``train/step.py``), what GSPMD makes of
JAX's: each rank holds its blocks of the parameters (``param_specs``) and
of the moments (``zero_specs``), computes its block of the batch with its
share of every product (megatron's column and row blocks of the
attention, the MLPs, rwkv6's mixes and the RG-LRU block, the vocabulary
cut over 'model', the MoE's E / model experts beside the replicated
router) and updates its blocks.  The serving cells run otherwise: the
parameters placed by their specs and gathered whole, each rank its block
of the batch (and of the decode state) by the batch axes, the next
tokens of a prefill all-gathered; under ``moe_impl="a2a"`` every rank
runs the whole batch and ``shard_map`` all-gathers its outputs.

Two counts per cell:

1. The FULL program (all layers, the train cells in
   ``TRAIN_MICROBATCHES`` microbatches): its memory (``argument_bytes``:
   the rank's blocks of the placed state and its inputs; ``temp_bytes``:
   the peak of what the step allocates; ``output_bytes``), and with
   ``--skip-probes`` its costs.
2. Depth PROBES at full width and batch, 2 and 3 layers of each layer type
   (decoder and encoder for audio, RG-LRU and local attention for hybrid;
   :data:`PROBE_DEPTHS`), one microbatch, extrapolated linearly: cost(L) =
   out + L * body.  An eager count has no scan body counted once; the
   probes keep the meta trace short.  Unlike JAX's, the out term subtracts
   every layer type a probe holds (JAX's decoder probes keep the whole
   encoder, which it then counts twice).

Host syncs cannot run on ``meta``: the MoE runs ``moe_dense`` (JAX's
choice; in a train cell each rank's experts on its tokens), or ``a2a``
under ``--opt`` (in a train cell the rank's sequence block exchanged with
its experts by all-to-alls over 'model'); ``moe_gmm`` reads its group
sizes on the host.  In the partitioned train cells ``seq_parallel`` (on
by default; ``dp_only`` turns it off) cuts the residual stream, and so
the saved block inputs, by sequence over 'model', and context-parallel
attention (where the heads do not divide the model axis, or
``cp_attention``, which ``--opt`` sets) gives each model rank its block
of the queries over every head.  The last model rank's block sees the
most keys, so such a cell is counted on that rank (the fake world's rank
``model - 1``: data index 0, model index ``model - 1``); every other cell
on rank 0.  The result says which (``model_index``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, cells, get_config
from ..distributed import sharding
from ..distributed.sharding import (gather_full, local_block, mesh_shape,
                                    param_specs, place_tree, set_mesh,
                                    shardings, zero_specs)
from ..models import build
from ..optim import AdamWConfig, OptState, adamw_init
from ..train import TrainState, make_train_step
from .hlo_stats import StepCounter, roofline_terms, tensor_leaves
from .input_specs import NamedSharding, _batch_axes, input_specs
from .mesh import MULTI_POD_SHAPE, POD_SHAPE, make_production_mesh

TRAIN_MICROBATCHES = 8     # bounds activation memory on the train cells


def _moe_impl(cfg, override=None):
    if override:
        return override
    return "dense" if cfg.moe is not None else "gmm"


# ------------------------------------------------------------- the world ---

def _register_fake_backend():
    """The ``fake`` backend (torch's testing fake process group) if this
    torch has not registered it."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        return
    except ImportError:
        pass
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)

    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A world of ``n`` ranks in this process, as rank ``rank`` of a fake
    process group (its collectives move nothing), ended on exit.  A
    running world of ``n`` ranks is used as it is; one of another size
    raises."""
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != n:
            raise RuntimeError(f"a dry run over {n} ranks needs a world of "
                               f"{n}; a world of {have} is running")
        yield False
        return
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=n)
    try:
        yield True
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the cell ---

def local_bytes(tree) -> int:
    """Bytes a rank holds of a tree's tensors (a DTensor's local block)."""
    total = 0
    for x in tensor_leaves(tree):
        if sharding.is_placed(x):
            x = x.to_local()
        total += x.numel() * x.element_size()
    return total


def _batch_only(spec, batch_axes) -> sharding.P:
    """``spec`` with only the batch axes kept: the port's model computes
    whole model dims on every rank."""
    keep = set(batch_axes or ())
    return sharding.P(*(tuple(a for a in sharding._axes_tuple(ax)
                              if a in keep) for ax in tuple(spec)))


def _rank_block(tree, shards, mesh, batch_axes):
    """This rank's block of every tensor of ``tree`` by the batch axes of
    its sharding (host ints and flags as they are)."""
    if isinstance(tree, dict):
        return {k: _rank_block(v, shards[k], mesh, batch_axes)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rank_block(v, s, mesh, batch_axes)
                          for v, s in zip(tree, shards))
    if isinstance(tree, torch.Tensor) and isinstance(shards, NamedSharding):
        return local_block(tree, mesh, _batch_only(shards.spec, batch_axes))
    return tree


def _draw(tree, gen, vocab: int, seq: int):
    """Random values for the abstract inputs on ``gen``'s device, seeded:
    token ids in [0, vocab), positions in [0, seq), normal embeddings;
    a decode state is made fresh (zeros)."""
    dev = gen.device
    if isinstance(tree, dict):
        return {k: _draw(v, gen, seq if k in ("positions", "mrope_pos")
                         else vocab, seq) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_draw(v, gen, vocab, seq) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.dtype.is_floating_point:
        return torch.randn(tree.shape, generator=gen, device=dev).to(
            tree.dtype)
    return torch.randint(0, vocab, tree.shape, generator=gen, device=dev,
                         dtype=tree.dtype)


def build_cell(cfg, shape_name: str, mesh, moe_impl=None, microbatches=None,
               dp_only: bool = False, *, device="meta", seed: int = 0):
    """Returns (fn, args): one rank's step and its arguments, ready for
    ``fn(*args)`` under ``sharding.set_mesh(mesh)``.  ``device="meta"``
    (the dry run) draws nothing; on another device the weights and inputs
    are drawn from ``seed`` (the card's check of the dry run)."""
    if dp_only:
        # pure data parallelism: params replicated over 'model', batch
        # sharded over every axis, no TP/SP activity.
        cfg = dataclasses.replace(cfg, seq_parallel=False,
                                  cp_attention=False)
    dev = torch.device(device)
    bundle = build(cfg)
    impl = _moe_impl(cfg, moe_impl)
    inputs, in_shards, kind = input_specs(cfg, shape_name, mesh,
                                          dp_only=dp_only)
    sh = SHAPES[shape_name]
    if dev.type == "meta":
        params = bundle.init_params(0, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = bundle.init_params(gen, device=dev)
        inputs = _draw(inputs, gen, cfg.vocab_size, sh["seq_len"])
        if kind == "decode":
            inputs["state"] = bundle.init_decode_state(
                sh["global_batch"], sh["seq_len"], device=dev)
    divisor = (1 << 30) if dp_only else mesh_shape(mesh)["model"]
    pspecs = param_specs(params, model_divisor=divisor)
    placed = place_tree(params, mesh, shardings(mesh, pspecs))

    if kind == "train":
        # ZeRO-1: the float32 moments (and the grad accumulator) also
        # shard over 'data'.
        step_mesh = mesh
        if dp_only:
            # the step's data axes are the whole mesh
            from torch.distributed.device_mesh import DeviceMesh

            step_mesh = DeviceMesh(mesh.device_type, mesh.mesh.flatten(),
                                   mesh_dim_names=("data",))
        zspecs = zero_specs(pspecs, params, step_mesh)
        zplace = shardings(step_mesh, zspecs)
        opt = adamw_init(params)
        if dp_only:
            placed = place_tree(params, step_mesh,
                                shardings(step_mesh, pspecs))
        state = TrainState(
            params=placed,
            opt=OptState(mu=place_tree(opt.mu, step_mesh, zplace),
                         nu=place_tree(opt.nu, step_mesh, zplace),
                         count=opt.count),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        mb = microbatches or TRAIN_MICROBATCHES
        step = make_train_step(bundle, AdamWConfig(), moe_impl=impl,
                               microbatches=mb,
                               grad_acc_specs=zspecs if mb > 1 else None)

        def train_step(state, batch):
            with set_mesh(step_mesh):
                return step(state, batch)
        return train_step, (state, inputs)

    # serving: moe_a2a cuts the global batch over the data axes itself
    whole = impl == "a2a" and cfg.moe is not None
    ba = None if whole else _batch_axes(mesh, sh["global_batch"], dp_only)
    local = _rank_block(inputs, in_shards, mesh, ba)

    if kind == "prefill":
        def prefill_step(params, batch):
            params = gather_full(params)
            kw = {k: v for k, v in batch.items() if k != "tokens"}
            with torch.no_grad():
                logits, _, _ = bundle.forward(params, batch["tokens"],
                                              moe_impl=impl, logits_slice=1,
                                              **kw)
                out = torch.argmax(logits, dim=-1)
            # out_shardings P(None, None): every rank the whole batch's
            return sharding._gather_global(
                out, (sh["global_batch"], 1), mesh,
                sharding.P(ba, None))
        return prefill_step, (placed, local)

    # decode: one new token against a populated length-S state
    extra_keys = tuple(k for k in ("enc_out", "mrope_pos") if k in local)

    def serve_fn(params, state, tokens, positions, *extra):
        params = gather_full(params)
        kws = {bundle.state_kwarg: state}
        kws.update(dict(zip(extra_keys, extra)))
        with torch.no_grad():
            logits, new_state, _ = bundle.forward(
                params, tokens, positions=positions, moe_impl=impl,
                logits_slice=1, **kws)
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, new_state

    args = (placed, local["state"], local["tokens"], local["positions"],
            *(local[k] for k in extra_keys))
    return serve_fn, args


def count_cell(cfg, shape_name, mesh, moe_impl, microbatches=None,
               dp_only=False, *, device="meta", seed=0):
    """One rank's step of the cell counted: {"flops", "bytes", "coll",
    "coll_detail", "kernels", "memory"} (``memory`` in JAX's fields)."""
    fn, args = build_cell(cfg, shape_name, mesh, moe_impl=moe_impl,
                          microbatches=microbatches, dp_only=dp_only,
                          device=device, seed=seed)
    arg_bytes = local_bytes(args)
    with set_mesh(mesh), StepCounter() as c:
        out = fn(*args)
    coll = c.collectives
    return {
        "flops": float(c.flops),
        "bytes": float(c.bytes),
        "coll": float(coll["bytes"]["total"]),
        "coll_detail": coll,
        "kernels": c.kernels,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out),
            "temp_bytes": c.peak_bytes,
            "peak_per_device": arg_bytes + c.peak_bytes,
        },
    }


# ------------------------------------------------------------ the probes ---

#: The probes' depths.  Two and three layers, not JAX's one and two: a
#: stacked leaf of one layer gathers over the model axis without the copy
#: that every deeper one takes, so depth 1 is off the line.
PROBE_DEPTHS = (2, 3)


def _probe_cfgs(cfg):
    """Probe (cfg, weight) sets per layer type.

    Returns list of (name, [probe_cfg_small, probe_cfg_big], layer_counts,
    (L_small, L_big)) such that total = out + sum_i counts_i * body_i, with
    body_i = (cost(big) - cost(small)) / (L_big - L_small) and out the
    first small probe's cost less every layer it holds (:func:`_depth`).
    """
    R = dataclasses.replace
    ls, lb = PROBE_DEPTHS
    if cfg.family == "audio":
        return [
            ("dec", [R(cfg, num_layers=ls, num_encoder_layers=ls,
                       unroll_layers=True),
                     R(cfg, num_layers=lb, num_encoder_layers=ls,
                       unroll_layers=True)],
             cfg.num_layers, (ls, lb)),
            ("enc", [R(cfg, num_layers=ls, num_encoder_layers=ls,
                       unroll_layers=True),
                     R(cfg, num_layers=ls, num_encoder_layers=lb,
                       unroll_layers=True)],
             cfg.num_encoder_layers, (ls, lb)),
        ]
    if cfg.family == "hybrid":
        n_attn = _depth("attn", cfg)
        n_rec = cfg.num_layers - n_attn
        return [
            ("rec", [R(cfg, num_layers=ls, block_pattern=("rglru",),
                       unroll_layers=True),
                     R(cfg, num_layers=lb, block_pattern=("rglru",),
                       unroll_layers=True)],
             n_rec, (ls, lb)),
            ("attn", [R(cfg, num_layers=ls, block_pattern=("local",),
                        unroll_layers=True),
                      R(cfg, num_layers=lb, block_pattern=("local",),
                        unroll_layers=True)],
             n_attn, (ls, lb)),
        ]
    return [("layer", [R(cfg, num_layers=ls, unroll_layers=True),
                       R(cfg, num_layers=lb, unroll_layers=True)],
             cfg.num_layers, (ls, lb))]


def _depth(name: str, cfg) -> int:
    """Layers of probe family ``name`` in ``cfg``."""
    if name == "enc":
        return cfg.num_encoder_layers
    if name in ("rec", "attn"):
        want = "rglru" if name == "rec" else "local"
        pat = cfg.block_pattern
        return sum(1 for i in range(cfg.num_layers)
                   if pat[i % len(pat)] == want)
    return cfg.num_layers


_KEYS = ("flops", "bytes", "coll")


def probe_extrapolate(cfg, shape_name, mesh, moe_impl, dp_only=False):
    """Per-device (flops, hbm_bytes, collective_bytes) extrapolated to the
    full depth from shallow probes."""
    probes = _probe_cfgs(cfg)
    total = {k: 0.0 for k in _KEYS}
    detail = {}
    first = None
    for name, (small, big), count, (ls, lb) in probes:
        # microbatches=1: the probes see the whole batch in one pass
        cs = count_cell(small, shape_name, mesh, moe_impl, microbatches=1,
                        dp_only=dp_only)
        cb = count_cell(big, shape_name, mesh, moe_impl, microbatches=1,
                        dp_only=dp_only)
        body = {k: (cb[k] - cs[k]) / (lb - ls) for k in _KEYS}
        detail[name] = {"per_layer": body, "count": count}
        if first is None:
            first = (small, cs)
        for k in total:
            total[k] += count * max(body[k], 0.0)
    small, cs = first
    out_term = {k: cs[k] - sum(_depth(n, small) * detail[n]["per_layer"][k]
                               for n, *_ in probes) for k in _KEYS}
    for k in total:
        total[k] += max(out_term[k], 0.0)
    detail["out"] = out_term
    return total, detail


def counted_rank(cfg, shape_name: str, multi_pod: bool,
                 dp_only: bool = False) -> int:
    """The rank of the production mesh's fake world a cell is counted on:
    the last model rank (data index 0) where its partitioned train step
    runs context-parallel attention, whose last query block reaches the
    most keys; else rank 0."""
    from ..models.layers import context_parallel

    shape, names = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    mp = dict(zip(names, shape))["model"]
    sh = SHAPES[shape_name]
    cp = (sh["kind"] == "train" and not dp_only
          and context_parallel(cfg, mp, sh["seq_len"]))
    return mp - 1 if cp else 0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             moe_impl=None, extra_opts=None, verbose=True,
             skip_probes=False):
    """The cell's dry run on the production mesh (one pod, or two with
    ``multi_pod``) over a fake world of its size: JAX's result dict."""
    opts = extra_opts or {}
    cfg = get_config(arch)
    ovr = {k: v for k, v in opts.items()
           if k in {f.name for f in dataclasses.fields(cfg)}}
    if ovr:
        cfg = dataclasses.replace(cfg, **ovr)
    dp_only = bool(opts.get("dp_only"))
    n = 512 if multi_pod else 256
    with fake_world(n, counted_rank(cfg, shape_name, multi_pod, dp_only)):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh.size()
        model_index = sharding.axis_index(mesh, "model")
        # 1. full program: its memory (and, without probes, its costs)
        t0 = time.time()
        full = count_cell(cfg, shape_name, mesh, moe_impl,
                          microbatches=opts.get("microbatches"),
                          dp_only=dp_only)
        t_trace = time.time() - t0
        # 2. probes: per-layer terms extrapolated to full depth
        if skip_probes:
            total, detail = full, {"note": "full program counted"}
        else:
            total, detail = probe_extrapolate(cfg, shape_name, mesh,
                                              moe_impl, dp_only=dp_only)

    terms = roofline_terms(total["flops"], total["bytes"], total["coll"],
                           chips)
    sh = SHAPES[shape_name]
    mult = 6 if sh["kind"] == "train" else 2
    model_flops = mult * cfg.active_param_count() * _tokens(shape_name)

    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "model_index": model_index, "kind": sh["kind"],
        "device": "meta",
        "moe_impl": _moe_impl(cfg, moe_impl) if cfg.moe else None,
        "compile_s": round(t_trace, 1),
        "flops_per_device": total["flops"],
        "hbm_bytes_per_device": total["bytes"],
        "coll_bytes_per_device": total["coll"],
        "coll_detail": full["coll_detail"],
        "kernels": full["kernels"],
        "probe_detail": detail if not skip_probes else {},
        "memory": full["memory"],
        "roofline": terms,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / (total["flops"] * chips)
                               if total["flops"] else 0.0),
    }
    if verbose:
        slim = {k: v for k, v in result.items() if k != "probe_detail"}
        print(json.dumps(slim, indent=1), flush=True)
    return result


def _tokens(shape_name: str) -> int:
    sh = SHAPES[shape_name]
    if sh["kind"] in ("train", "prefill"):
        return sh["seq_len"] * sh["global_batch"]
    return sh["global_batch"]          # decode: one token per sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--opt", action="store_true",
                    help="optimized config: a2a MoE + cp_attention")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a in ARCHS for s in cells(a)]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in todo:
        tag = f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}"
        print(f"=== {tag} ===", flush=True)
        try:
            moe_impl = args.moe_impl or ("a2a" if args.opt else None)
            extra = {"cp_attention": True} if args.opt else None
            res = run_cell(arch, shape, multi_pod=args.multi_pod,
                           moe_impl=moe_impl, extra_opts=extra,
                           skip_probes=args.skip_probes)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
        except Exception as e:      # one cell's failure is reported, the
            traceback.print_exc()   # others still run
            failures.append((tag, str(e)))
    if failures:
        print("FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print(f"all {len(todo)} cells counted OK")


if __name__ == "__main__":
    main()
