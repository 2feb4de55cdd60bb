"""Build the PyTorch/CUDA port on one NVIDIA GPU, drive its main path and
check it.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. card     — ``nvidia-smi`` name and power limit, torch's device name/count.
2. build    — nvcc builds ``src/repro_torch/kernels/csrc/tick_loop.cu``;
              ptxas registers / spills / shared memory per instantiation used.
3. goldens  — the 20 RUN_GOLDEN cells through ``repro_torch.api.run`` on the
              ``cuda`` executor, bit for bit; one launch per cell.
4. smoke    — the Figure 2 ``--smoke`` grid swept with the ``cuda`` and the
              ``reference`` executor on the card: final state rows and all
              seven traces bit-equal.
5. fig2     — the main path: all 72 Figure 2 cells through
              ``repro_torch.api.sweep``, one launch per group, against
              ``tests/torch_goldens/fig2_full.json``; then the kernel and its
              plain version on the same groups, compared and timed.
6. tune     — 4,096 EEMT lanes (256 SLA points x 16 bandwidth schedules) in
              one launch: kernel vs plain on every lane, times, bound, memory.

The last two lines are the kernel summary and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the JAX package; it needs a CUDA card and the rest of the repository.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations of one lane-tick of csrc/tick_loop.cu, counted from the
# source: ~22 per partition (channel split, channel rate, drain, window) and
# ~70 per lane (contention, capacity, power, accumulators, the controller
# tick amortised over its stride).
OPS_PER_PARTITION_TICK = 22
OPS_PER_LANE_TICK = 70
TRACE_BYTES_PER_TICK = 28    # 7 traces x 4 B

# RUN_GOLDEN of tests/test_environments.py (api.run, total_s=240, dt=0.1):
# (completed, time_s, energy_j, avg_tput_MBps, avg_power_w).  The five cells
# marked "op-by-op" hold the JAX package's values under jax.disable_jit():
# its jitted goldens differ there in the last bits of one field (XLA fuses
# the float32 ops), and the port follows the op-by-op semantics (ROADMAP,
# queue 3; tests/test_torch_api.py checks this table against JAX).
RUN_GOLDEN = {
    ("chameleon", "eemt", "fast"): (True, 1.2000000000000002, 31.04885482788086, 833.3333333333333, 25.87404568990071),
    ("chameleon", "eemt", "one"): (True, 0.7000000000000001, 15.856439590454102, 714.2858014787946, 22.65205655779157),
    ("chameleon", "me", "fast"): (True, 4.0, 47.53553771972656, 249.99996948242188, 11.88388442993164),  # op-by-op
    ("chameleon", "me", "one"): (True, 2.7, 28.187297821044922, 185.18519648799187, 10.439739933720341),  # op-by-op
    ("chameleon", "wget/curl", "fast"): (True, 10.0, 187.87521362304688, 99.99998779296875, 18.787521362304688),
    ("chameleon", "wget/curl", "one"): (True, 8.3, 140.1924591064453, 60.24096385542168, 16.89065772366811),
    ("chameleon", "ismail-target", "fast"): (True, 5.6000000000000005, 127.40544128417969, 178.57147216796872, 22.750971657889227),
    ("chameleon", "ismail-target", "one"): (True, 4.1000000000000005, 82.59339141845703, 121.95125672875379, 20.14472961425781),
    ("chameleon", "eett", "fast"): (True, 2.0, 39.50807571411133, 500.0000305175781, 19.754037857055664),
    ("chameleon", "eett", "one"): (True, 1.4000000000000001, 25.693153381347656, 357.1429007393973, 18.352252415248323),
    ("cloudlab", "eemt", "fast"): (True, 8.4, 99.49142456054688, 119.04756091889881, 11.844217209588914),
    ("cloudlab", "eemt", "one"): (True, 4.3, 58.72537612915039, 116.27909105877544, 13.657064216081487),  # op-by-op
    ("cloudlab", "me", "fast"): (True, 11.600000000000001, 97.5721435546875, 86.20689129007273, 8.41139168574892),  # op-by-op
    ("cloudlab", "me", "one"): (True, 4.5, 40.65987014770508, 111.11109754774306, 9.035526699490017),
    ("cloudlab", "wget/curl", "fast"): (True, 22.1, 357.330322265625, 45.24885773119344, 16.168792862697963),  # op-by-op
    ("cloudlab", "wget/curl", "one"): (True, 20.1, 305.2291564941406, 24.87559759794776, 15.18553017383784),
    ("cloudlab", "ismail-target", "fast"): (True, 10.8, 200.1354217529297, 92.59255303276909, 18.53105756971571),
    ("cloudlab", "ismail-target", "one"): (True, 6.0, 108.07884979248047, 83.3333231608073, 18.013141632080078),
    ("cloudlab", "eett", "fast"): (True, 9.200000000000001, 104.67521667480469, 108.69562563688858, 11.377740942913551),
    ("cloudlab", "eett", "one"): (True, 4.2, 57.62987518310547, 119.04764084588913, 13.721398853120348),
}

# Figure 2 axes (the port's copy of benchmarks/fig2.py and
# benchmarks/common.py; tests/test_torch_api.py holds them equal).
FIG2_TOOLS = ("wget/curl", "http/2", "ismail-min-energy", "ismail-max-tput",
              "ME", "EEMT")
FIG2_SMOKE = (("chameleon",), ("small", "mixed"), ("wget/curl", "ME", "EEMT"))
FIG2_TESTBEDS = ("chameleon", "cloudlab", "didclab")
FIG2_DATASETS = ("small", "medium", "large", "mixed")

# Tune-sized sweep: 4 x 4 x 4 x 4 SLA points x 16 bandwidth schedules.
TUNE_ALPHA = (0.05, 0.1, 0.15, 0.2)
TUNE_BETA = (0.02, 0.05, 0.1, 0.15)
TUNE_DELTA_CH = (1, 2, 4, 8)
TUNE_MAX_CH = (16, 32, 64, 128)
TUNE_SEEDS = range(16)
TUNE_TOTAL_S = 1800.0
TUNE_SEGMENT_S = 60.0


def golden_scenarios(executor="auto"):
    """The 20 RUN_GOLDEN cells as port Scenarios, keyed like RUN_GOLDEN."""
    from repro_torch import api
    from repro_torch.core.types import CHAMELEON, CLOUDLAB, DatasetSpec

    profiles = {"chameleon": CHAMELEON, "cloudlab": CLOUDLAB}
    datasets = {"fast": (DatasetSpec("a", 200, 400.0, 2.0),
                         DatasetSpec("b", 10, 600.0, 60.0)),
                "one": (DatasetSpec("c", 50, 500.0, 10.0),)}
    out = {}
    for pn, cn, dn in RUN_GOLDEN:
        kw = {"target_tput_mbps": 400.0} if cn in ("eett",
                                                   "ismail-target") else {}
        out[(pn, cn, dn)] = api.Scenario(
            profile=profiles[pn], datasets=datasets[dn],
            controller=api.make_controller(cn, **kw), total_s=240.0, dt=0.1,
            executor=executor)
    return out


def budget_for(profile) -> float:
    """Per-testbed transfer budget (s): the 1 Gbps testbeds get longer."""
    return 28800.0 if profile.bandwidth_mbps < 500 else 7200.0


def fig2_scenarios(smoke=False, executor="auto"):
    """[(testbed, dataset, tool), Scenario] of the Figure 2 grid."""
    from repro_torch import api
    from repro_torch.core import types

    datasets = {"small": (types.SMALL_FILES,), "medium": (types.MEDIUM_FILES,),
                "large": (types.LARGE_FILES,), "mixed": types.MIXED}
    testbeds, dss, tools = FIG2_SMOKE if smoke else (
        FIG2_TESTBEDS, FIG2_DATASETS, FIG2_TOOLS)
    cells = []
    for tb in testbeds:
        for ds in dss:
            for tool in tools:
                profile = types.TESTBEDS[tb]
                ctrl = (api.make_controller(tool, max_ch=64)
                        if tool in ("ME", "EEMT") else tool)
                cells.append(((tb, ds, tool), api.Scenario(
                    profile=profile, datasets=datasets[ds], controller=ctrl,
                    cpu=types.CpuProfile(),
                    total_s=900.0 if smoke else budget_for(profile),
                    name=f"fig2/{tb}/{ds}/{tool}", executor=executor)))
    return cells


def tune_bw_schedules():
    """16 piecewise-constant schedules: 60 s segments at 0.3-1.0 of nominal,
    drawn with numpy from seeds 0-15."""
    import numpy as np

    n_seg = int(TUNE_TOTAL_S // TUNE_SEGMENT_S)
    per_seg = int(round(TUNE_SEGMENT_S / 0.1))
    return [np.repeat(np.random.default_rng(s).uniform(0.3, 1.0, n_seg)
                      .astype(np.float32), per_seg) for s in TUNE_SEEDS]


def tune_scenarios(executor="auto"):
    """4,096 EEMT lanes on Chameleon x MIXED (one sweep group)."""
    from repro_torch import api
    from repro_torch.core import types

    schedules = tune_bw_schedules()
    out = []
    for a in TUNE_ALPHA:
        for b in TUNE_BETA:
            for d in TUNE_DELTA_CH:
                for m in TUNE_MAX_CH:
                    ctrl = api.make_controller("EEMT", alpha=a, beta=b,
                                               delta_ch=d, max_ch=m)
                    for s, bw in zip(TUNE_SEEDS, schedules):
                        out.append(api.Scenario(
                            profile=types.CHAMELEON, datasets=types.MIXED,
                            controller=ctrl, total_s=TUNE_TOTAL_S, dt=0.1,
                            bw_schedule=bw, executor=executor,
                            name=f"tune/a{a}/b{b}/d{d}/m{m}/s{s}"))
    return out


# ---------------------------------------------------------------- helpers --

class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def groups_on_card(scenarios, dev):
    """[(key, (prow, bw, f0, i0))] for every sweep group, on ``dev``."""
    from repro_torch.api import scenario as S
    from repro_torch.core import engine

    prepared, groups = S._prepare_groups(scenarios, dev)
    out = []
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, dev)
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        out.append((key, (prow, inp.bw, f0, i0)))
    return out


def call(fn, key, rows):
    return fn(key.ctrl_code, key.env_code, key.cpu, *rows, dt=key.dt,
              ctrl_every=key.ctrl_every)


def compare_outputs(a, b):
    """Max |a - b| over final rows and traces, and whether all are equal."""
    import torch

    ta = [a[0], a[1], *a[2]]
    tb = [b[0], b[1], *b[2]]
    equal = all(torch.equal(x, y) for x, y in zip(ta, tb))
    err = max(float((x.double() - y.double()).abs().max()) if x.numel()
              else 0.0 for x, y in zip(ta, tb))
    return equal, err


def time_cuda(fn, reps):
    """Median wall time (ms) of ``fn()`` on the card over ``reps`` runs, by
    CUDA events, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def executed_lane_ticks(metrics, n_steps):
    """Ticks each lane actually ran: through its done tick, or the horizon."""
    import torch

    done = metrics.done.to(torch.int32)
    completed = done.any(dim=1)
    first = done.argmax(dim=1) + 1
    return int(torch.where(completed, first, n_steps).sum())


def bound_of(groups_rows, lane_ticks):
    """(bound_ms, bound_by, bytes, ops) for a set of tick_loop calls: every
    trace written once, the parameter/state rows read and written once, and
    the bandwidth share of every executed lane-tick read once; operations
    per executed lane-tick over the float32 peak."""
    nbytes = 0
    ops = 0
    for (key, (prow, bw, f0, i0)), ticks in zip(groups_rows, lane_ticks):
        b, n = bw.shape
        nbytes += TRACE_BYTES_PER_TICK * n * b
        nbytes += 4 * (prow.numel() + 2 * f0.numel() + 2 * i0.numel())
        nbytes += 4 * ticks
        ops += ticks * (OPS_PER_LANE_TICK
                        + OPS_PER_PARTITION_TICK * key.n_partitions)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def instances_of(scenarios, dev):
    """(P, KIND, SCALING) kernel instantiations a sweep would launch."""
    from repro_torch.api import scenario as S
    from repro_torch.api.controllers import as_controller
    from repro_torch.api.environments import as_environment
    from repro_torch.kernels import tick_loop as tl

    keys = [S._group_key(as_controller(sc.controller),
                         as_environment(sc.environment), sc,
                         len(sc.datasets), dev) for sc in scenarios]
    merged = S._merged_partition_counts(keys)
    out = set()
    for k in keys:
        kind, scaling = tl.kernel_spec(k.ctrl_code, k.env_code)
        out.add((merged[k], kind, scaling))
    return out


# ----------------------------------------------------------------- phases --

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    return smoke(torch.device("cuda"))


def smoke(dev) -> int:
    """Every phase, on the CUDA device ``dev``."""
    import torch

    from repro_torch import api
    from repro_torch.core import tickstate
    from repro_torch.kernels import build
    from repro_torch.kernels import tick_loop as tl

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind!r} x{count}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load_tick_loop()
    print(f"[2 build] tick_loop.cu built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    report = build.ptxas_report(build.build_log("tick_loop.cu"))
    names = ["ME", "EEMT", "EETT", "ISMAIL", "STATIC"]
    used = set()
    for scs in (list(golden_scenarios().values()),
                [s for _, s in fig2_scenarios(smoke=False)],
                tune_scenarios()[:1]):
        used |= instances_of(scs, dev)
    by_inst = {build.tick_loop_instance(k): v for k, v in report.items()}
    for p, k, s in sorted(used):
        check((p, k, s) in by_inst, f"no ptxas entry for P={p} {names[k]}")
        print(f"[2 build] P={p} {names[k]}{'+scaling' if s else ''}: "
              f"{by_inst[(p, k, s)]}")

    # 3. goldens
    before = tl.tick_loop.launches
    bad = []
    for cell, sc in golden_scenarios(executor="cuda").items():
        r = api.run(sc, device=dev)
        got = (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
               r.avg_power_w)
        if got != RUN_GOLDEN[cell]:
            bad.append((cell, got, RUN_GOLDEN[cell]))
    launched = tl.tick_loop.launches - before
    check(not bad, f"RUN_GOLDEN mismatches on the card: {bad}")
    check(launched == len(RUN_GOLDEN),
          f"{launched} launches for {len(RUN_GOLDEN)} golden cells")
    print(f"[3 goldens] {len(RUN_GOLDEN)}/{len(RUN_GOLDEN)} RUN_GOLDEN cells "
          f"bit-exact on the cuda executor, {launched} launches", flush=True)

    # 4. smoke grid: cuda executor vs reference executor, both on the card
    outs = {}
    for ex in ("cuda", "reference"):
        scs = [s for _, s in fig2_scenarios(smoke=True, executor=ex)]
        _, runs = api.run_groups(scs, device=dev)
        rows = []
        for r in sorted(runs, key=lambda r: r.indices):
            lay = tickstate.TickLayout(r.key.n_partitions)
            rows.append((*lay.pack_state(r.sim, r.ts), *r.metrics))
        outs[ex] = rows
    torch.cuda.synchronize()
    n_eq = sum(all(torch.equal(x, y) for x, y in zip(a, b))
               for a, b in zip(outs["cuda"], outs["reference"]))
    check(n_eq == len(outs["cuda"]),
          f"smoke grid: {len(outs['cuda']) - n_eq} groups differ between "
          f"the kernel and the plain version")
    print(f"[4 smoke] fig2 --smoke grid ({len(FIG2_SMOKE[0]) * len(FIG2_SMOKE[1]) * len(FIG2_SMOKE[2])} cells, "
          f"{n_eq} groups): cuda == reference on the card, final rows and "
          f"7 traces bit-equal", flush=True)

    # 5. the main path: full Figure 2 through api.sweep
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fig2_full.json")) as f:
        gold = json.load(f)
    cells = fig2_scenarios(smoke=False)
    scs = [s for _, s in cells]
    n_groups = api.group_count(scs, device=dev)
    check(n_groups == gold["group_count"],
          f"group_count {n_groups} != JAX's {gold['group_count']}")
    tl.tick_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = api.sweep(scs, device=dev)
    wall = time.perf_counter() - t0
    main_launches = tl.tick_loop.launches
    check(main_launches == n_groups,
          f"main path launched the kernel {main_launches} times for "
          f"{n_groups} groups")
    rows = {(r["testbed"], r["dataset"], r["tool"]): r for r in gold["rows"]}
    n_exact = 0
    for (cell, _), r in zip(cells, results):
        g = rows[cell]
        check(r.completed == g["completed"] and r.time_s == g["time_s"],
              f"fig2 {cell}: completed/time_s {r.completed}/{r.time_s} vs "
              f"{g['completed']}/{g['time_s']}")
        for f in ("energy_j", "avg_tput_MBps"):
            check(abs(getattr(r, f) - g[f]) <= 1e-5 * abs(g[f]),
                  f"fig2 {cell}: {f} {getattr(r, f)} vs {g[f]}")
        n_exact += all(getattr(r, f) == g[f] for f in
                       ("time_s", "energy_j", "avg_tput_MBps",
                        "avg_power_w"))
    headline = fig2_headline(cells, results)
    print(f"[5 fig2] {len(results)} cells in {n_groups} groups "
          f"({main_launches} launches), sweep wall {wall:.3f} s; "
          f"{sum(r.completed for r in results)} completed; vs "
          f"fig2_full.json: completed/time_s exact, energy/tput rtol 1e-5, "
          f"{n_exact}/{len(results)} cells bit-exact", flush=True)
    print(f"[5 fig2] headline {json.dumps(headline)}; JAX "
          f"{json.dumps(gold['headline'])}", flush=True)

    # 5b. kernel vs plain version at the main path's shapes, timed
    grs = groups_on_card(scs, dev)
    kern = [call(tl.tick_loop, k, rows_) for k, rows_ in grs]
    t0 = time.perf_counter()
    plain = [call(tl.tick_loop_reference, k, rows_) for k, rows_ in grs]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [compare_outputs(a, b) for a, b in zip(kern, plain)]
    max_err = max(e for _, e in errs)
    check(all(eq for eq, _ in errs),
          f"fig2 groups: kernel != plain version (max |err| {max_err})")
    ticks = [executed_lane_ticks(m, k.n_steps)
             for (k, _), (_, _, m) in zip(grs, kern)]
    ms = time_cuda(lambda: [call(tl.tick_loop, k, r) for k, r in grs], 5)
    bound_ms, bound_by, nbytes, ops = bound_of(grs, ticks)
    shapes = ", ".join(f"{r[1].shape[0]}x{r[1].shape[1]}" for _, r in grs)
    print(f"[5 fig2] kernel vs plain on the card: {len(grs)} groups "
          f"(lanes x ticks: {shapes}) bit-equal; kernel {ms:.3f} ms "
          f"(median of 5, {len(grs)} launches), plain {plain_ms:.1f} ms "
          f"(one run); {sum(ticks)} executed lane-ticks; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops)",
          flush=True)

    # 6. tune-sized sweep: 4,096 lanes in one group
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tune_results = api.sweep(tune_scenarios(), device=dev)
    tune_wall = time.perf_counter() - t0
    check(len(tune_results) == len(TUNE_ALPHA) * len(TUNE_BETA)
          * len(TUNE_DELTA_CH) * len(TUNE_MAX_CH) * len(TUNE_SEEDS),
          "tune sweep size")
    peak = torch.cuda.max_memory_allocated()
    tscs = tune_scenarios(executor="cuda")
    grs_t = groups_on_card(tscs, dev)
    check(len(grs_t) == 1, f"tune sweep split into {len(grs_t)} groups")
    (key_t, rows_t), = grs_t
    kern_t = call(tl.tick_loop, key_t, rows_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_t = call(tl.tick_loop_reference, key_t, rows_t)
    torch.cuda.synchronize()
    plain_t_ms = (time.perf_counter() - t0) * 1e3
    eq_t, err_t = compare_outputs(kern_t, plain_t)
    check(eq_t, f"tune sweep: kernel != plain version (max |err| {err_t})")
    _, runs_ref = api.run_groups(tune_scenarios(executor="reference"),
                                 device=dev)
    lay = tickstate.TickLayout(key_t.n_partitions)
    ref_rows = (*lay.pack_state(runs_ref[0].sim, runs_ref[0].ts),
                *runs_ref[0].metrics)
    ker_rows = (kern_t[0], kern_t[1], *[m if f != "done" else m != 0
                                        for f, m in zip(
                                            kern_t[2]._fields, kern_t[2])])
    check(all(torch.equal(x, y) for x, y in zip(ker_rows, ref_rows)),
          "tune sweep: cuda executor != reference executor")
    del plain_t, runs_ref
    ticks_t = executed_lane_ticks(kern_t[2], key_t.n_steps)
    ms_t = time_cuda(lambda: call(tl.tick_loop, key_t, rows_t), 5)
    bound_t, by_t, nbytes_t, ops_t = bound_of(grs_t, [ticks_t])
    b, n = rows_t[1].shape
    print(f"[6 tune] {b} lanes x {n} ticks, 1 group: kernel == plain on "
          f"all lanes; kernel {ms_t:.3f} ms (median of 5); "
          f"{ticks_t} executed lane-ticks = {ticks_t / (ms_t / 1e3):.4g} "
          f"lane-ticks/s; {nbytes_t} B written/read, memory bound "
          f"{nbytes_t / HBM_BYTES_PER_S * 1e3:.4f} ms (bound {bound_t:.4f} "
          f"ms by {by_t}); plain {plain_t_ms:.1f} ms; peak memory "
          f"{peak} B; sweep end to end {tune_wall:.3f} s; "
          f"{sum(r.completed for r in tune_results)} completed", flush=True)

    print(json.dumps({"kernels": [{
        "name": "tick_loop", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tick_loop.cu",
        "replaces": "src/repro/core/engine.py:612",
        "launches": main_launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def fig2_headline(cells, results) -> dict:
    """The paper's headline comparisons on the mixed dataset
    (benchmarks/fig2.py::headline)."""
    by = {cell: r for (cell, _), r in zip(cells, results)}
    out = {}
    for tb in dict.fromkeys(c[0] for c, _ in cells):
        me, imin = by[(tb, "mixed", "ME")], by[(tb, "mixed",
                                                "ismail-min-energy")]
        eemt, imax = by[(tb, "mixed", "EEMT")], by[(tb, "mixed",
                                                    "ismail-max-tput")]
        out[tb] = {
            "me_energy_reduction_pct":
                100.0 * (1 - me.energy_j / imin.energy_j),
            "eemt_tput_gain_pct":
                100.0 * (eemt.avg_tput_gbps / imax.avg_tput_gbps - 1),
            "eemt_energy_reduction_pct":
                100.0 * (1 - eemt.energy_j / imax.energy_j),
        }
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
