"""Worlds of several processes on the CPU for the port's multi-rank tests
(tests/test_torch_{mesh,collectives,moe_a2a,dryrun,tensor_parallel,
tensor_parallel_families}.py).

``start_world(case, world, tmp)`` spawns ``world`` Python processes, each
a rank of a gloo process group over a ``FileStore`` in ``tmp`` (no
socket; a world of one starts none), each running ``CASES[case](rank,
world, **kw)`` and pickling what it returns; ``join`` waits for them all, at most ``JOIN_TIMEOUT_S``, and
fails the test (killing the ranks) if one dies or the world outlives it:
a hung collective must not hang the run.  Start every world a module
needs, then join them, so that they run at once.

This module imports torch and the port, never JAX: the ranks stay light.
``python tests/torch_dist.py <case> <rank> <world> <store> <out> <json>``
is a rank's command line.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The longest a world may take, from its start to its last rank's exit.
JOIN_TIMEOUT_S = 120.0
#: Threads a rank's torch uses (four ranks share the CPU with the other
#: test workers).
RANK_THREADS = 2


class World:
    def __init__(self, case, world, procs, outs, logs):
        self.case, self.world = case, world
        self.procs, self.outs, self.logs = procs, outs, logs
        self.t0 = time.monotonic()


def start_world(case: str, world: int, tmp, **kw) -> World:
    """Spawn the ``world`` ranks of ``case`` (keywords as JSON)."""
    d = os.path.join(str(tmp), f"{case}_{world}")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]),
        OMP_NUM_THREADS=str(RANK_THREADS))
    procs, outs, logs = [], [], []
    for rank in range(world):
        out = os.path.join(d, f"rank{rank}.pkl")
        log = os.path.join(d, f"rank{rank}.log")
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(rank),
                 str(world), os.path.join(d, "store"), out, json.dumps(kw)],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        outs.append(out)
        logs.append(log)
    return World(case, world, procs, outs, logs)


def join(w: World, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Every rank's result, in rank order; raises AssertionError if a rank
    fails or the world is not done within ``timeout`` s of its start."""
    def kill(why):
        for p in w.procs:
            if p.poll() is None:
                p.kill()
        for p in w.procs:
            p.wait()
        tails = []
        for r, log in enumerate(w.logs):
            with open(log) as f:
                tails.append(f"--- rank {r} ---\n" + f.read()[-3000:])
        raise AssertionError(f"world {w.case} x{w.world}: {why}\n"
                             + "\n".join(tails))

    while True:
        codes = [p.poll() for p in w.procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            kill(f"rank {bad[0]} exited with {codes[bad[0]]}")
        if all(c == 0 for c in codes):
            break
        if time.monotonic() - w.t0 > timeout:
            kill(f"not done after {timeout:.0f} s")
        time.sleep(0.05)
    res = []
    for out in w.outs:
        with open(out, "rb") as f:
            res.append(pickle.load(f))
    return res


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_np(v) for v in x)
    return x


# ------------------------------------------------------ shared inputs ---

#: tests/test_moe_a2a.py's shapes: 8 experts top-2, d 32, ff 64, x [4, 8,
#: 32]; float32 weights (JAX's test draws bf16 weights and float32 x).
MOE = dict(E=8, k=2, d=32, ff=64, B=4, T=8)


def moe_inputs(T=None):
    """(params, x) as numpy float32, made from numpy seeds 0 (params, at
    ``init_moe``'s scales) and 1 (x): the same in the golden script, the
    ranks and the tests."""
    E, d, ff = MOE["E"], MOE["d"], MOE["ff"]
    rng = np.random.default_rng(0)

    def normal(shape, scale):
        return (rng.standard_normal(shape, np.float32) * scale).astype(
            np.float32)
    p = {"router": normal((d, E), 1 / np.sqrt(d)),
         "wg": normal((E, d, ff), 1 / np.sqrt(d)),
         "wu": normal((E, d, ff), 1 / np.sqrt(d)),
         "wd": normal((E, ff, d), 1 / np.sqrt(ff))}
    x = np.random.default_rng(1).standard_normal(
        (MOE["B"], T or MOE["T"], d), np.float32)
    return p, x


def moe_config(**kw):
    """The MoE layer's config in either package (``ModelConfig`` and
    ``MoEConfig`` of ``repro_torch.models.common`` or
    ``repro.models.common``)."""
    mod = kw.pop("common")
    return mod.ModelConfig(
        name="m", family="moe", num_layers=1, d_model=MOE["d"], num_heads=4,
        num_kv_heads=4, d_ff=MOE["ff"], vocab_size=64, dtype="float32",
        moe=mod.MoEConfig(num_experts=MOE["E"], top_k=MOE["k"],
                          d_ff_expert=MOE["ff"]))


# ------------------------------------------------------------- cases ---

def case_collectives(rank, world):
    """chunked_psum on a 1-D ("x",) mesh of the world."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import P, psum, shard_map
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("x",))
    out = {}
    x = torch.arange(4.0 * world * 2)
    out["sharded"] = shard_map(lambda v: C.chunked_psum(v, "x", 4),
                               mesh=mesh, in_specs=P("x"),
                               out_specs=P())(x)
    out["replicated"] = shard_map(lambda v: C.chunked_psum(v, "x", 4),
                                  mesh=mesh, in_specs=P(), out_specs=P())(x)
    g = torch.as_tensor(np.random.default_rng(rank).standard_normal(
        (12, 5), np.float32))
    for name, v, n in (("float", g, 4), ("odd", g[:7], 4), ("scalar",
                       g[0, 0], 4), ("one_chunk", g, 1)):
        def both(t, n=n):
            return C.chunked_psum(t, "x", n), psum(t, "x")
        out[name] = shard_map(both, mesh=mesh, in_specs=P(),
                              out_specs=(P(), P()))(v)
    out["g"] = g
    return _np(out)


def case_mesh(rank, world):
    """make_host_mesh's shapes and groups, shard_map's cut and reassembly
    and its gradients, and a tuple-of-axes group."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    for model in (1, 2, world):
        m = make_host_mesh(model=model, device="cpu")
        out[f"shape_{model}"] = S.mesh_shape(m)
        out[f"coord_{model}"] = tuple(m.get_coordinate())
        out[f"model_ranks_{model}"] = dist.get_process_group_ranks(
            S.axis_group(m, "model"))
        out[f"all_ranks_{model}"] = dist.get_process_group_ranks(
            S.axis_group(m, ("data", "model")))
    try:
        make_host_mesh(model=2 * world, device="cpu")
    except ValueError as e:
        out["too_wide"] = str(e)
    m = make_host_mesh(model=2, device="cpu")
    with S.set_mesh(m):
        am = S.get_abstract_mesh()
        out["abstract"] = (am.empty, am.shape, am.axis_names)
    x = torch.arange(24.0).reshape(4, 6).requires_grad_(True)
    spec = S.P("data", "model")

    def body(v):
        return v * (1.0 + S.axis_index(m, "model")), S.pmean(v.sum(), (
            "data", "model"))
    y, s = S.shard_map(body, mesh=m, in_specs=spec,
                       out_specs=(spec, S.P()))(x)
    (y.square().sum() + 3.0 * s).backward()
    out["y"], out["s"], out["grad"] = y, s, x.grad

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.tree import leaves

    params = build(get_smoke_config("qwen3-0.6b")).init_params(
        0, device="cpu")
    specs = S.param_specs(params, model_divisor=2)
    placed = S.place_tree(params, m, S.shardings(m, specs))
    out["roundtrip"] = all(torch.equal(a, b) for a, b in zip(
        leaves(params), leaves(S.gather_full(placed))))
    out["local_wq"] = tuple(placed["blocks"]["attn"]["wq"].to_local().shape)
    out["zero"] = S.zero_specs(specs, params, m)
    return _np(out)


def case_moe_a2a(rank, world):
    """moe_a2a on a 2 x 2 mesh: output and aux at capacity factors 8.0
    and 0.5, the gradient of sum(y^2) + aux at 4.0, and at a T the model
    axis does not divide (tokens replicated over it)."""
    import torch

    from repro_torch.distributed.moe_a2a import moe_a2a
    from repro_torch.distributed.sharding import set_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common

    cfg = moe_config(common=common)
    m = make_host_mesh(model=2, device="cpu")
    out = {}
    with set_mesh(m):
        for tag, T, cf, grad in (("ample", None, 8.0, False),
                                 ("tight", None, 0.5, False),
                                 ("grad", None, 4.0, True),
                                 ("t7", 7, 8.0, True)):
            pn, xn = moe_inputs(T)
            p = {k: torch.from_numpy(v).requires_grad_(grad)
                 for k, v in pn.items()}
            x = torch.from_numpy(xn).requires_grad_(grad)
            y, aux = moe_a2a(cfg, p, x, capacity_factor=cf)
            out[tag] = {"y": y, "aux": aux}
            if grad:
                loss = torch.sum(torch.square(y)) + aux
                gs = torch.autograd.grad(loss, [*p.values(), x])
                out[tag]["grads"] = dict(zip([*p, "x"], gs))
    return _np(out)


def case_serve(rank, world, tp):
    """The serving launcher at --tp ``tp`` on this world."""
    from repro_torch.launch import serve

    return _np(serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "6", "--tp", str(tp)]))


def run_train_launcher(tp, dtype="bfloat16", microbatches=1):
    """The training launcher's losses at ``--tp tp``: qwen3-0.6b smoke (in
    ``dtype``), 3 steps of 4 x 16.  Its ingest reads shards in order here
    (``batches(..., tuned=False)``: the tuned fetcher's threads deliver
    them in any order, so two runs would see other batches)."""
    import dataclasses

    from repro_torch.launch import train

    real = (train.batches, train.get_smoke_config)
    train.batches = lambda *a, **kw: real[0](*a, **dict(kw, tuned=False))
    train.get_smoke_config = lambda arch: dataclasses.replace(
        real[1](arch), dtype=dtype)
    try:
        rep = train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                          "cpu", "--steps", "3", "--batch", "4", "--seq",
                          "16", "--tp", str(tp), "--microbatches",
                          str(microbatches)])
    finally:
        train.batches, train.get_smoke_config = real
    return rep.losses


def case_train(rank, world, tp, dtype="bfloat16", microbatches=1):
    """:func:`run_train_launcher` on this world."""
    return run_train_launcher(tp, dtype, microbatches)


def case_train_a2a(rank, world):
    """qwen3-moe smoke in float32 under ``moe_impl="a2a"`` on a 2 x 2 mesh,
    two steps of one seeded 4 x 16 batch: the state placed (the launcher's
    step: the partitioned one) and plain (global arrays, as JAX's), at the
    model's capacity factor; placed again at ample capacity (E / k:
    nothing drops), and the gmm step without a mesh.  Each run's losses,
    cross-entropies and final parameters."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   place_state)

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32")
    bundle = build(cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 17), dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    mesh = make_host_mesh(model=2, device="cpu")

    def run(impl, placed, on_mesh=True):
        state = init_train_state(bundle, 0, device="cpu")
        step = make_train_step(bundle, opt, moe_impl=impl)
        with S.set_mesh(mesh) if on_mesh else contextlib.nullcontext():
            if placed:
                state = place_state(state, mesh)
            losses, ces = [], []
            for _ in range(2):
                state, met = step(state, batch)
                losses.append(float(met["loss"]))
                ces.append(float(met["ce"]))
        return {"losses": losses, "ce": ces,
                "params": S.gather_full(state.params)}

    out = {"placed": run("a2a", True), "global": run("a2a", False)}
    with A2AFactor(cfg.moe.num_experts / cfg.moe.top_k):
        out["ample"] = run("a2a", True)
    out["gmm"] = run("gmm", False, on_mesh=False)
    return _np(out)


#: The partitioned step's cases (tests/test_torch_tensor_parallel.py): the
#: dense smoke configs in float32, three steps of B 4 x T 48 (numpy seed
#: 7 a step), from ``convert.random_lm_params(cfg, 0)``.
TP_ARCHS = ("qwen3-0.6b", "qwen2-0.5b", "olmo-1b", "yi-9b")
TP_STEPS, TP_B, TP_T = 3, 4, 48
TP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def tp_config(arch, configs="repro_torch.configs", **moe):
    """``arch``'s smoke config in float32, from ``configs`` (the port's
    ``repro_torch.configs`` or JAX's ``repro.configs``); moonshot's with
    two shared experts, so that their MLP is 2 x d_ff wide as in the full
    config; ``moe``: other MoEConfig fields replaced."""
    import dataclasses
    import importlib

    mod = importlib.import_module(configs)
    cfg = dataclasses.replace(mod.get_smoke_config(arch), dtype="float32")
    if arch == "moonshot-v1-16b-a3b":
        moe = dict(num_shared_experts=2, **moe)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def tp_batches(vocab, T=TP_T):
    """The TP_STEPS global batches of ``SyntheticSource``'s Zipf tokens
    (test_torch_train's), B TP_B x ``T``: {tokens, labels} as int32 numpy,
    a tenth of the labels masked (-1, numpy seed 7), so that the data
    ranks' shares of the unmasked labels differ."""
    from repro_torch.data import SyntheticSource, batches

    it = batches(SyntheticSource(vocab, 4096), batch=TP_B, seq=T,
                 tuned=False)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(TP_STEPS):
        b = {k: v.numpy() for k, v in next(it).items()}
        b["labels"][rng.random(b["labels"].shape) < 0.1] = -1
        out.append(b)
    it.close()
    return out


#: The MoE family's partitioned cases: both MoE archs (moonshot with two
#: shared experts, ``tp_config``) under each ``moe_impl`` of the
#: trainer's; at two data ranks on tp_moe_batches.  The a2a runs
#: qwen3-moe at ample capacity (``TP_A2A_FACTOR``: nothing drops).
TP_MOE_ARCH = "qwen3-moe-30b-a3b"
TP_MOE_ARCHS = (TP_MOE_ARCH, "moonshot-v1-16b-a3b")
TP_MOE_IMPLS = ("gmm", "dense")
TP_A2A_FACTOR = 8.0


def tp_moe_batches(vocab):
    """tp_batches with the first half of each batch's rows (the first data
    rank's at two data ranks) further masked, 0.4 of its labels (numpy
    seed 8), so the data ranks' counts of unmasked labels are far apart."""
    rng = np.random.default_rng(8)
    out = tp_batches(vocab)
    for b in out:
        lb = b["labels"][:TP_B // 2]
        lb[rng.random(lb.shape) < 0.4] = -1
    return out


def tp_params(cfg):
    """``convert.random_lm_params(cfg, 0)`` (JAX's tree, drawn by numpy)
    as the port's CPU tensors."""
    from repro_torch import convert

    return convert.lm_params_from_jax(convert.random_lm_params(cfg, 0), cfg,
                                      "cpu")


def tp_steps(cfg, mesh, bs, moe_impl="gmm", tree=None, saved=False):
    """float32 steps of ``cfg`` from :func:`tp_params` (or the numpy
    parameter ``tree`` in JAX's layout) with the state placed on ``mesh``,
    one a batch of ``bs``: every step's metrics, the final weights and
    moments gathered whole, and the shapes of this rank's blocks of the
    parameters and moments; with ``saved``, step 1's saved block inputs
    (:class:`SavedBlockInputs`: bytes, blocks)."""
    import torch

    from repro_torch import convert
    from repro_torch.distributed import sharding as S
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainState, make_train_step, place_state

    params = (tp_params(cfg) if tree is None else
              convert.lm_params_from_jax(tree, cfg, "cpu"))
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(build(cfg), AdamWConfig(**TP_OPT),
                           moe_impl=moe_impl)
    out = {}
    with S.set_mesh(mesh):
        state = place_state(state, mesh)
        metrics = []
        for i, b in enumerate(bs):
            with SavedBlockInputs() if saved and i == 0 else \
                    contextlib.nullcontext() as s:
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            if s is not None:
                out["saved"] = (s.bytes, s.inputs)
            metrics.append({k: float(v) for k, v in m.items()})
        local = S._map_with_path(lambda _, x: tuple(x.to_local().shape),
                                 (state.params, state.opt.mu))
        full = S.gather_full((state.params, state.opt.mu))
    return {"metrics": metrics, "params": full[0], "mu": full[1],
            "local": local, "step": int(state.step), **out}


#: The sequence- and context-parallel variants of the partitioned step
#: (tests/test_torch_tensor_parallel.py): name -> (arch, config fields
#: replaced, T, moe_impl).  ``sp_off``: sequence parallelism off (JAX's
#: ``dp_only`` turns it off), against the default on; ``cp``: context-
#: parallel attention by ``cp_attention`` where the heads divide the
#: axis; ``cp6``: qwen2 smoke with 6 heads (GQA 3), which 4 does not
#: divide; ``t45``: a T that 2 does not divide (the whole stream);
#: ``sp``: the default (for the bytes each rank saves).
TP_VARIANTS = {
    "sp_off/qwen3-0.6b": ("qwen3-0.6b", {"seq_parallel": False}, TP_T,
                          "gmm"),
    "sp_off/yi-9b": ("yi-9b", {"seq_parallel": False}, TP_T, "gmm"),
    "cp/qwen3-0.6b": ("qwen3-0.6b", {"cp_attention": True}, TP_T, "gmm"),
    "cp6/qwen2-0.5b": ("qwen2-0.5b", {"num_heads": 6, "num_kv_heads": 2,
                                      "head_dim": 16}, TP_T, "gmm"),
    "t45/qwen2-0.5b": ("qwen2-0.5b", {}, 45, "gmm"),
    "t45/qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}, 45, "gmm"),
    "sp/qwen3-0.6b": ("qwen3-0.6b", {}, TP_T, "gmm"),
    "sp/qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}, TP_T, "gmm"),
}


def tp_variant(name, configs="repro_torch.configs"):
    """(config from ``configs``, batches, moe_impl) of TP_VARIANTS[name]."""
    import dataclasses

    arch, fields, T, impl = TP_VARIANTS[name]
    cfg = dataclasses.replace(tp_config(arch, configs), **fields)
    return cfg, tp_batches(cfg.vocab_size, T), impl


class SavedBlockInputs:
    """While entered, the bytes autograd saves of the remat blocks' inputs
    (the tensors the models hand ``torch.utils.checkpoint``, each block's
    first tensor argument: ``lm``'s, ``rwkv6``'s, ``rglru``'s layers and
    ``whisper``'s encoder and decoder layers): every saved tensor seen by
    ``saved_tensors_hooks`` whose storage is one of those inputs', each
    counted once (``bytes``; ``inputs``: the blocks run).  It keeps
    addresses only, so it holds no tensor alive."""

    def __enter__(self):
        import torch

        from repro_torch.models import lm, rglru, rwkv6, whisper

        self._mods = [(m, m.checkpoint) for m in (lm, rwkv6, rglru, whisper)]
        self._inputs, self._saved = set(), set()

        def patched(real):
            def checkpoint(fn, *args, **kw):
                x = next(a for a in args if isinstance(a, torch.Tensor))
                self._inputs.add(x.data_ptr())
                self.inputs += 1
                return real(fn, *args, **kw)
            return checkpoint

        def pack(t):
            self._saved.add((t.data_ptr(), t.untyped_storage().nbytes()))
            return t
        self.inputs = 0
        for m, real in self._mods:
            m.checkpoint = patched(real)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)
        for m, real in self._mods:
            m.checkpoint = real
        self.bytes = sum(n for p, n in self._saved if p in self._inputs)


def tp_saved(cfg, mesh, bs, moe_impl="gmm"):
    """The bytes of the block inputs a rank saves in one partitioned step
    (:func:`tp_steps` on ``bs[:1]``) of ``cfg``, and the blocks run."""
    with SavedBlockInputs() as s:
        tp_steps(cfg, mesh, bs[:1], moe_impl)
    return s.bytes, s.inputs


def case_tp_variants(rank, world, model, names, saved=()):
    """On the (world / model, model) host mesh: TP_VARIANTS ``names``'
    TP_STEPS float32 steps (:func:`tp_steps`), and for each variant of
    ``saved`` the block inputs' bytes a rank saves in step 1 beside the
    same step's with sequence parallelism off (:func:`tp_saved`)."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for name in names:
        cfg, bs, impl = tp_variant(name)
        out[name] = tp_steps(cfg, mesh, bs, impl)
    out["saved"] = {}
    for name in saved:
        cfg, bs, impl = tp_variant(name)
        off = dataclasses.replace(cfg, seq_parallel=False)
        out["saved"][name] = {"sp": tp_saved(cfg, mesh, bs, impl),
                              "off": tp_saved(off, mesh, bs, impl)}
    return _np(out)


def case_tp_train(rank, world, model, archs=TP_ARCHS, uneven=False):
    """Each arch's TP_STEPS float32 steps (:func:`tp_steps`) on the
    (world / model, model) host mesh, on tp_batches (``uneven``:
    tp_moe_batches)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for arch in archs:
        cfg = tp_config(arch)
        out[arch] = tp_steps(cfg, mesh, (tp_moe_batches if uneven else
                                         tp_batches)(cfg.vocab_size))
    return _np(out)


#: The recurrent, VLM and audio families' partitioned step
#: (tests/test_torch_tensor_parallel_families.py): their smoke configs in
#: float32, TP_STEPS steps of tp_batches from ``convert.random_lm_params(
#: cfg, 0)``.  qwen2-vl's M-RoPE sections fitted to its head of 16
#: (tests/test_torch_vlm.py's), its image a grid of FAM_GRID patches.
FAM_ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "qwen2-vl-2b", "whisper-small")
FAM_MROPE = (2, 3, 3)
FAM_GRID = (2, 4)
#: The variants: name -> (arch, config fields replaced, T, options):
#: ``gate1``: the RG-LRU's gates one block of the whole width (wider than
#: a rank's share: its inputs gathered); ``cp``: context-parallel
#: attention by ``cp_attention`` (whisper's encoder, decoder and
#: cross-attention; qwen2-vl's M-RoPE on the query block; recurrentgemma's
#: window); ``v500``: a vocabulary padded to 512 (the mask on the last
#: rank's block); ``t45``: a T the axis does not divide (whisper: its
#: decoder; the encoder's 16 frames still cut); ``tv30``: 30 image patches
#: (a grid of 5 x 6), longer than a rank's block.
FAM_VARIANTS = {
    "gate1/recurrentgemma-2b": ("recurrentgemma-2b", {}, TP_T,
                                {"gate_blocks": 1}),
    "cp/recurrentgemma-2b": ("recurrentgemma-2b", {"cp_attention": True},
                             TP_T, {}),
    "cp/whisper-small": ("whisper-small", {"cp_attention": True}, TP_T, {}),
    "v500/whisper-small": ("whisper-small", {"vocab_size": 500}, TP_T, {}),
    "t45/rwkv6-7b": ("rwkv6-7b", {}, 45, {}),
    "t45/recurrentgemma-2b": ("recurrentgemma-2b", {}, 45, {}),
    "t45/whisper-small": ("whisper-small", {}, 45, {}),
    "tv30/qwen2-vl-2b": ("qwen2-vl-2b", {}, TP_T, {"grid": (5, 6)}),
    "cp/qwen2-vl-2b": ("qwen2-vl-2b", {"cp_attention": True}, TP_T, {}),
}


def mrope_positions(B, T, grid):
    """[3, B, T] int32 M-RoPE positions (tests/test_torch_vlm.py's): the
    grid's rows x cols patches (t 0, h the row, w the column), then the
    text at max(rows, cols) + i in all three."""
    rows, cols = grid
    r, c = np.divmod(np.arange(rows * cols), cols)
    text = max(rows, cols) + np.arange(T - rows * cols)
    pos = np.stack([np.concatenate([np.zeros(rows * cols, int), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.broadcast_to(pos[:, None], (3, B, T)).astype(np.int32)


def fam_case(name, configs="repro_torch.configs"):
    """(config from ``configs``, batches, numpy parameter tree) of an arch
    of FAM_ARCHS (its defaults) or of FAM_VARIANTS[name]: tp_batches of
    its vocabulary and T, each with the family's inputs (whisper's frames
    [B, frames, D], qwen2-vl's patch embeddings and M-RoPE positions;
    numpy seed 3), and ``convert.random_lm_params(cfg, 0)`` (its gates
    redrawn at ``gate_blocks`` blocks, numpy seed 11)."""
    import dataclasses

    from repro_torch import convert

    arch, fields, T, opts = FAM_VARIANTS.get(name, (name, {}, TP_T, {}))
    cfg = tp_config(arch, configs)
    if cfg.mrope:
        fields = dict(mrope_sections=FAM_MROPE, **fields)
    cfg = dataclasses.replace(cfg, **fields)
    rng = np.random.default_rng(3)
    extra = {}
    if cfg.family == "audio":
        extra["frame_embeds"] = rng.standard_normal(
            (TP_B, cfg.encoder_positions, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        grid = opts.get("grid", FAM_GRID)
        extra["vision_embeds"] = rng.standard_normal(
            (TP_B, grid[0] * grid[1], cfg.d_model), np.float32)
        extra["mrope_pos"] = mrope_positions(TP_B, T, grid)
    bs = [dict(b, **extra) for b in tp_batches(cfg.vocab_size, T)]
    tree = convert.random_lm_params(cfg, 0)
    if "gate_blocks" in opts:
        n = opts["gate_blocks"]
        g = np.random.default_rng(11)
        for layer in tree["layers"]:
            for gate in ("gate_a", "gate_x"):
                if "rec" in layer:
                    w = layer["rec"][gate]["w"]
                    bd = w.shape[0] * w.shape[1] // n
                    layer["rec"][gate]["w"] = (g.standard_normal(
                        (n, bd, bd), np.float32) / np.sqrt(bd)).astype(
                            np.float32)
    return cfg, bs, tree


def case_fam(rank, world, model, names):
    """On the (world / model, model) host mesh: each of ``names``' (an
    arch of FAM_ARCHS or a FAM_VARIANTS name) TP_STEPS float32 steps
    (:func:`tp_steps`, step 1's saved block inputs too)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for name in names:
        cfg, bs, tree = fam_case(name)
        out[name] = tp_steps(cfg, mesh, bs, tree=tree, saved=True)
    return _np(out)


def case_fam_route(rank, world):
    """For every arch of ``configs.ARCHS`` (its smoke config in float32,
    the family's inputs as :func:`fam_case`'s), whether one step of a
    state placed on the 1 x 1 host mesh runs the partitioned step
    (enters ``sharding.partitioned``)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   place_state)

    mesh = make_host_mesh(model=1, device="cpu")
    real, entered = S.partitioned, []

    def partitioned(m):
        entered.append(True)
        return real(m)
    S.partitioned = partitioned
    out = {}
    try:
        for arch in ARCHS:
            cfg, bs, _ = fam_case(arch) if arch in FAM_ARCHS else (
                tp_config(arch), tp_batches(tp_config(arch).vocab_size),
                None)
            bundle = build(dataclasses.replace(cfg, num_layers=1)
                           if cfg.family != "hybrid" else cfg)
            step = make_train_step(bundle, AdamWConfig(**TP_OPT))
            with S.set_mesh(mesh):
                state = place_state(init_train_state(bundle, 0, device="cpu"),
                                    mesh)
                entered.clear()
                step(state, {k: torch.from_numpy(v) for k, v in bs[0].items()})
            out[arch] = bool(entered)
    finally:
        S.partitioned = real
    return out


class A2AFactor:
    """While entered, the model's ``moe_a2a`` runs at capacity factor
    ``factor`` (it calls it with the default 1.25, as JAX's does)."""

    def __init__(self, factor):
        self.factor = factor

    def __enter__(self):
        import functools

        from repro_torch.distributed import moe_a2a as A

        self.orig = A.moe_a2a
        A.moe_a2a = functools.partial(self.orig, capacity_factor=self.factor)

    def __exit__(self, *exc):
        from repro_torch.distributed import moe_a2a as A

        A.moe_a2a = self.orig


def case_tp_moe(rank, world, model, uneven=False, a2a=True):
    """The MoE family's partitioned steps on the (world / model, model)
    host mesh: each of TP_MOE_ARCHS under each of TP_MOE_IMPLS
    (:func:`tp_steps`, on tp_batches, ``uneven``: tp_moe_batches), keyed
    ``arch/impl``; with ``a2a``, qwen3-moe under ``moe_impl="a2a"`` at
    TP_A2A_FACTOR on tp_batches, its load-balancing term off (``a2a``),
    and one step with it on (``a2a_aux``)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for arch in TP_MOE_ARCHS:
        cfg = tp_config(arch)
        bs = (tp_moe_batches if uneven else tp_batches)(cfg.vocab_size)
        for impl in TP_MOE_IMPLS:
            out[f"{arch}/{impl}"] = tp_steps(cfg, mesh, bs, impl)
    if a2a:
        with A2AFactor(TP_A2A_FACTOR):
            cfg = tp_config(TP_MOE_ARCH, load_balance_coef=0.0)
            out["a2a"] = tp_steps(cfg, mesh, tp_batches(cfg.vocab_size),
                                  "a2a")
            cfg = tp_config(TP_MOE_ARCH)
            out["a2a_aux"] = tp_steps(cfg, mesh,
                                      tp_batches(cfg.vocab_size)[:1], "a2a")
    return _np(out)


def tp_moe_step1(cfg, mesh, moe_impl):
    """The gradients of qwen3-moe's loss on tp_batches' first batch at
    :func:`tp_params`, taken as the partitioned step does (inside
    ``sharding.partitioned(mesh)`` on this rank's blocks) at one data
    rank, and without a mesh (tp 1)."""
    import torch

    from repro_torch.distributed import sharding as S
    from repro_torch.models import build
    from repro_torch.train.step import loss_and_grads, make_loss_fn

    params = tp_params(cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in tp_batches(cfg.vocab_size)[0].items()}
    loss_fn = make_loss_fn(build(cfg), moe_impl)
    specs = S.param_specs(params, model_divisor=S.mesh_shape(mesh)["model"])
    local = S._map_with_path(
        lambda path, x: S.local_block(x, mesh, S._at(specs, path)), params)
    with S.partitioned(mesh):
        region = loss_and_grads(loss_fn, local, batch)[3]
    return region, loss_and_grads(loss_fn, params, batch)[3]


def case_tp_moe_parts(rank, world, model):
    """On the (1, model) host mesh: the router's step-1 gradient of both
    MoE archs under gmm and dense, taken in the partitioned region and
    at tp 1 (:func:`tp_moe_step1`); qwen3-moe's under a2a at TP_A2A_FACTOR
    in the region; and moonshot's shared experts' output on this rank's
    blocks of layer 0 in the region and whole without one."""
    import torch

    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L

    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for arch in TP_MOE_ARCHS:
        cfg = tp_config(arch)
        for impl in TP_MOE_IMPLS:
            region, whole = tp_moe_step1(cfg, mesh, impl)
            out[f"{arch}/{impl}"] = {
                "region": region["blocks"]["moe"]["router"],
                "tp1": whole["blocks"]["moe"]["router"]}
    with A2AFactor(TP_A2A_FACTOR):
        region, _ = tp_moe_step1(tp_config(TP_MOE_ARCH), mesh, "a2a")
    out["a2a"] = region["blocks"]["moe"]["router"]
    cfg = tp_config("moonshot-v1-16b-a3b")
    shared = {k: v[0] for k, v in
              tp_params(cfg)["blocks"]["moe"]["shared"].items()}
    specs = S.param_specs({"moe": {"shared": shared}}, model_divisor=model)
    mine = {k: S.local_block(v, mesh, specs["moe"]["shared"][k])
            for k, v in shared.items()}
    xf = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (24, cfg.d_model), np.float32))
    with S.partitioned(mesh):
        out["shared"] = L.shared_experts(cfg, {"shared": mine}, xf)
    out["shared_tp1"] = L.shared_experts(cfg, {"shared": shared}, xf)
    out["shared_block"] = tuple(mine["wd"].shape)
    return _np(out)


def case_a2a_region(rank, world):
    """moe_a2a inside a partitioned region of the 2 x 2 host mesh, on this
    rank's blocks of test_moe_a2a's inputs (its data rank's rows of x, the
    router whole, its model rank's experts): output and aux at capacity
    factors 8.0 and 0.5, and the gradient of the global ``sum(y^2) +
    aux`` (each data rank's share of it, the replicated leaves' gradients
    summed over 'data') at 4.0 and at T 7 (which the model axis does not
    divide).  The aux is the data ranks' mean."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.moe_a2a import moe_a2a
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common

    cfg = moe_config(common=common)
    mesh = make_host_mesh(model=2, device="cpu")
    nd = S.mesh_shape(mesh)["data"]
    dgroup = S.axis_group(mesh, "data")
    out = {}
    for tag, T, cf, grad in (("ample", None, 8.0, False),
                             ("tight", None, 0.5, False),
                             ("grad", None, 4.0, True),
                             ("t7", 7, 8.0, True)):
        pn, xn = moe_inputs(T)
        p = {k: S.local_block(torch.from_numpy(v), mesh, S.P() if
                              k == "router" else S.P("model"))
             .clone().requires_grad_(grad) for k, v in pn.items()}
        x = S.local_block(torch.from_numpy(xn), mesh, S.P("data")).clone() \
            .requires_grad_(grad)
        with S.partitioned(mesh):
            y, aux = moe_a2a(cfg, p, x, capacity_factor=cf)
            res = {"y": y.detach()}
            if grad:
                loss = torch.sum(torch.square(y)) + aux / nd
                gs = dict(zip([*p, "x"], torch.autograd.grad(
                    loss, [*p.values(), x])))
                for k in p:         # replicated over 'data'
                    dist.all_reduce(gs[k], group=dgroup)
                res["grads"] = gs
        aux = aux.detach().clone()
        dist.all_reduce(aux, group=dgroup)
        res["aux"] = aux / nd
        out[tag] = res
    return _np(out)


#: The vocabulary and the sequence lengths of the cut cross-entropy's
#: cases (one chunk, and two with a remainder).
TP_CE_VOCAB, TP_CE_T = 96, (40, 700)


def tp_ce_inputs(T):
    """(logits [2, T, TP_CE_VOCAB] float32, labels [2, T] int32 with a
    tenth masked) from numpy seed T."""
    rng = np.random.default_rng(T)
    logits = rng.standard_normal((2, T, TP_CE_VOCAB), dtype=np.float32) * 3
    labels = rng.integers(0, TP_CE_VOCAB, (2, T)).astype(np.int32)
    labels[rng.random((2, T)) < 0.1] = -1
    return logits, labels


def case_tp_parts(rank, world, model):
    """On the (world / model, model) host mesh: ``cross_entropy`` of this
    rank's block of the vocabulary (value and gradient), and
    ``global_norm`` over the blocks of a gradient tree placed by
    ``param_specs`` (qwen3 smoke's shapes, numpy seed 3), beside the
    norm of the whole tree."""
    import torch

    import torch.distributed.tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import global_norm
    from repro_torch.train import cross_entropy
    from repro_torch.tree import leaves, tree_map

    mesh = make_host_mesh(model=model, device="cpu")
    out = {"ce": {}}
    with S.partitioned(mesh) as ax:
        n = TP_CE_VOCAB // model
        for T in TP_CE_T:
            logits, labels = tp_ce_inputs(T)
            block = torch.from_numpy(
                logits[..., ax.rank * n:(ax.rank + 1) * n]).requires_grad_()
            v = cross_entropy(block, torch.from_numpy(labels), model=ax)
            (g,) = torch.autograd.grad(v, block)
            out["ce"][T] = {"value": v, "grad": g}
    rng = np.random.default_rng(3)
    grads = tree_map(lambda m: torch.from_numpy(rng.standard_normal(
        tuple(m.shape), dtype=np.float32)), build(tp_config(
            "qwen3-0.6b")).init_params(0, device="meta"))
    specs = S.param_specs(grads, model_divisor=model)
    placed = S.place_tree(grads, mesh, S.shardings(mesh, specs))
    cut = [any(a == "model" for a in s if a) for s in leaves(
        S._map_with_path(lambda _, s: tuple(s), specs))]
    out["norm_blocks"] = global_norm(
        tree_map(lambda x: x.to_local(), placed), cut=cut,
        group=S.axis_group(mesh, "model"))
    out["norm_whole"] = global_norm(grads)
    out["cut"] = cut
    # the placed init against placing a whole one: the same blocks
    from repro_torch.train import init_train_state, place_state

    out["init"] = {}
    for arch in ("qwen3-0.6b", "yi-9b", "rwkv6-7b", "recurrentgemma-2b",
                 "qwen2-vl-2b", "whisper-small"):
        bundle = build(get_smoke_config(arch))
        a = init_train_state(bundle, 0, device="cpu", mesh=mesh)
        b = place_state(init_train_state(bundle, 0, device="cpu"), mesh)
        out["init"][arch] = [
            (x.placements == y.placements and x.shape == y.shape
             and torch.equal(x.to_local(), y.to_local()))
            for x, y in zip(leaves(a), leaves(b))
            if isinstance(y, torch.distributed.tensor.DTensor)]
    return _np(out)


def case_production(rank, world):
    """make_production_mesh on torch's fake process group of 256 and of
    512 ranks, in one process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import mesh_shape
    from repro_torch.launch.mesh import close_world, make_production_mesh

    out = {}
    for n, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        m = make_production_mesh(multi_pod=multi, device="cpu")
        out[n] = (mesh_shape(m), tuple(m.mesh_dim_names),
                  tuple(m.mesh.shape))
        close_world()
    return out


#: Small cells for counting the dry run's step on the CPU: (shape name,
#: SHAPES entry) added to ``repro_torch.configs.SHAPES`` while a count runs.
DRYRUN_SHAPES = {
    "train_tiny": dict(kind="train", seq_len=64, global_batch=4),
    "prefill_tiny": dict(kind="prefill", seq_len=64, global_batch=4),
    "decode_tiny": dict(kind="decode", seq_len=64, global_batch=4),
    "prefill_vlm": dict(kind="prefill", seq_len=1088, global_batch=2),
}


def dryrun_config(arch):
    """``arch``'s smoke config at a head width the attention kernels take
    (64; qwen2-vl's M-RoPE sections halve with it), as the dry run counts
    only what the card can launch."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    if cfg.family == "ssm" or cfg.resolved_head_dim in (64, 128, 256):
        return cfg
    kw = dict(head_dim=64)
    if cfg.mrope:
        kw["mrope_sections"] = (8, 12, 12)
    return dataclasses.replace(cfg, **kw)


def count_dryrun_cells(cells, mesh, device):
    """{(arch, shape): count_cell's counts} of the dry run's step for each
    cell (on ``device``, microbatches 2) over ``mesh``."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import count_cell

    saved = dict(configs.SHAPES)
    configs.SHAPES.update(DRYRUN_SHAPES)
    try:
        return {(a, s): count_cell(dryrun_config(a), s, mesh, None,
                                   microbatches=2, device=device)
                for a, s in cells}
    finally:
        configs.SHAPES.clear()
        configs.SHAPES.update(saved)


def case_dryrun(rank, world, cells):
    """The dry run's counts of ``cells`` on this rank, on CPU tensors over
    the host mesh (model 2)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=2, device="cpu")
    res = count_dryrun_cells([tuple(c) for c in cells], mesh, "cpu")
    return {f"{a}/{s}": {k: r[k] for k in ("flops", "bytes", "coll_detail")}
            for (a, s), r in res.items()}


def case_many(rank, world, parts):
    """Several cases in turn on one world (fewer processes to start):
    ``parts`` is a list of [name, case, keywords]; {name: result}."""
    return {name: CASES[case](rank, world, **kw) for name, case, kw in parts}


CASES = {"collectives": case_collectives, "mesh": case_mesh,
         "moe_a2a": case_moe_a2a, "serve": case_serve, "train": case_train,
         "train_a2a": case_train_a2a, "dryrun": case_dryrun,
         "production": case_production, "tp_train": case_tp_train,
         "tp_parts": case_tp_parts, "tp_moe": case_tp_moe,
         "tp_moe_parts": case_tp_moe_parts, "a2a_region": case_a2a_region,
         "tp_variants": case_tp_variants, "fam": case_fam,
         "fam_route": case_fam_route, "many": case_many}


def main(argv):
    case, rank, world, store, out, kw = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(RANK_THREADS)
    if world > 1:       # a world of one starts its own (the launchers do)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
    res = CASES[case](rank, world, **json.loads(kw))
    with open(out + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".tmp", out)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
