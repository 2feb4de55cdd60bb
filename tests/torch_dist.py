"""Worlds of several processes on the CPU for the port's multi-rank tests
(tests/test_torch_{mesh,collectives,moe_a2a}.py).

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


def join(w: World) -> list:
    """Every rank's result, in rank order; raises AssertionError if a rank
    fails or the world is not done within ``JOIN_TIMEOUT_S``."""
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
        if time.monotonic() - w.t0 > JOIN_TIMEOUT_S:
            kill(f"not done after {JOIN_TIMEOUT_S:.0f} s")
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
    step) and plain (global arrays, as JAX's), at the model's capacity
    factor; placed again at ample capacity (E / k: nothing drops), and the
    gmm step without a mesh.  Each run's losses, cross-entropies and final
    parameters."""
    import contextlib
    import dataclasses
    import functools

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import moe_a2a as A
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
    orig = A.moe_a2a
    A.moe_a2a = functools.partial(
        orig, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    try:
        out["ample"] = run("a2a", True)
    finally:
        A.moe_a2a = orig
    out["gmm"] = run("gmm", False, on_mesh=False)
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


def case_many(rank, world, parts):
    """Several cases in turn on one world (fewer processes to start):
    ``parts`` is a list of [name, case, keywords]; {name: result}."""
    return {name: CASES[case](rank, world, **kw) for name, case, kw in parts}


CASES = {"collectives": case_collectives, "mesh": case_mesh,
         "moe_a2a": case_moe_a2a, "serve": case_serve, "train": case_train,
         "train_a2a": case_train_a2a,
         "production": case_production, "many": case_many}


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
