"""The CUDA tick-loop source on the CPU, for every environment family:
``csrc/tick_loop.cu`` compiled whole with g++ against a stub CUDA runtime
(tests/tick_host/: each block's threads run one after another), under
FTZ | DAZ and without contraction (``-ffp-contract=off``; x86-64 g++ emits
no fused multiply-add without ``-mfma``) — the kernel's ``-ftz=true
-fmad=false`` — and launched through the wrapper's own argument marshalling
(``tick_loop.marshal_and_launch_groups``).  Held to the plain version
(``tick_loop_reference``) bit for bit: final rows and all seven traces.

The learned controller (``repro_torch.learn``) runs the same way: the
block stages the MLP's weight table into shared memory (here the block's
threads run as std::threads meeting at ``__syncthreads``) and every lane
featurizes, runs the MLP in the plain version's order and applies its
actions.  glibc's ``tanhf`` / ``log1pf`` / ``log10f`` stand in for
libdevice's and PyTorch's CPU functions for the plain version's; the runs
below are held bit for bit all the same (measured: equal; a last-bit
difference could only show through a flipped near-tie argmax).

A sweep's groups run together (``tick_loop.launch_groups``: one launch of
``tick_loop_grouped_kernel`` per partition count among them), driven
through ``engine.run_cuda_groups`` with the host build standing in for
``tick_loop.tick_loop_grouped``, and each group held to the plain version
on the group alone, on the Figure 2 ``--smoke`` grid, the fig_dvfs and
GreenDataFlow grids (at a 30 s horizon; at their own horizons against the
groups' own launches), a sweep mixing P 1 and 3 under the reference and
lossy-wan environments, and a learned group beside EEMT.

One exception: lossy-wan's jitter calls the C library's ``sinf`` here and
``torch.sin`` in the plain version, two routines on the CPU (on the card
both are libdevice's ``sinf``: tests/test_torch_gpu.py holds them
bit-equal there).  Its groups are held to rtol 1e-5 of each tensor's
largest magnitude, with the int32 rows and the cores and done traces
exact (measured: 2.4e-7).
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import scenario as S
from repro_torch.core import engine, tickstate
from repro_torch.core.types import (CHAMELEON, CLOUDLAB, CpuProfile,
                                    DatasetSpec)
from repro_torch.kernels import build
from repro_torch.kernels import tick_loop as tl

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "src", "repro_torch", "kernels", "csrc")
JITTER_RTOL = 1e-5

FAST = (DatasetSpec("a", 200, 400.0, 2.0), DatasetSpec("b", 10, 600.0, 60.0))
ONE = (DatasetSpec("c", 50, 500.0, 10.0),)
LOG = [dict(start_s=k * 2.0, end_s=(k + 1) * 2.0, mb=bw * 2.0, rtt_s=0.04)
       for k, bw in enumerate((800.0, 1200.0, 400.0, 1000.0))]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the tick-loop source for the host")
    lib = tmp_path_factory.mktemp("tick_host") / "libtick_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-pthread",
                    "-I", os.path.join(HERE, "tick_host"), "-I", CSRC,
                    "-o", str(lib), os.path.join(HERE, "tick_host",
                                                 "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    return build.bind_tick_loop(ctypes.CDLL(str(lib)),
                                "host_tick_loop_grouped_launch")


@pytest.fixture(scope="module")
def host_launch(host_lib):
    """One lane batch in one launch of the host build: ``(controller, env,
    cpu, prow, bw, f0, i0, *, dt, ctrl_every)`` -> (error code, (f32, i32,
    TickMetrics))."""
    def launch(controller, env, cpu, prow, bw, f0, i0, *, dt, ctrl_every):
        err, outs = tl.marshal_and_launch_groups(
            host_lib, host_lib.host_tick_loop_grouped_launch,
            [(controller, env, cpu, prow, bw, f0, i0, dt, ctrl_every)],
            stream=None)
        return err, outs and outs[0]
    return launch


ENVIRONMENTS = {
    "reference": None,
    "lossy-wan": "lossy-wan",
    "lossy-wan-clean": api.LossyWanNetworkModel(loss_rate=0.0,
                                                jitter_frac=0.0),
    "lossy-wan-loss": api.LossyWanNetworkModel(loss_rate=1e-3,
                                               jitter_frac=0.0),
    "big-little": api.make_environment("big-little", n_big=4),
    "dvfs-hp-race": api.make_environment("dvfs", tech="hp", idle="race",
                                         n_big=4),
    "dvfs-lp-capped": api.make_environment("dvfs", tech="lp",
                                           max_freq_ghz=1.8),
    "dvfs-matched": api.Environment(
        network=api.DvfsNetworkModel(),
        energy=api.DvfsEnergyModel.matched(CpuProfile())),
    "logfit": api.make_environment("logfit", log=LOG, bin_s=2.0),
    "logfit-constant": api.make_environment("logfit"),
    "lossy-wan+dvfs": api.Environment(
        network=api.LossyWanNetworkModel(loss_rate=1e-3, jitter_frac=0.0),
        energy=api.DvfsEnergyModel.for_tech("lp", idle="race")),
    "logfit+big-little": api.Environment(
        network=api.make_environment("logfit", log=LOG, bin_s=2.0).network,
        energy=api.BigLittleEnergyModel(n_big=2)),
}
CONTROLLERS = [api.make_controller("ME"), api.make_controller("EEMT"),
               api.make_controller("EEMT", scaling=False),
               api.make_controller("EETT", target_tput_mbps=400.0),
               api.make_controller("ismail-target", target_tput_mbps=400.0),
               "wget/curl"]


@pytest.mark.parametrize("name", sorted(ENVIRONMENTS))
def test_kernel_source_equals_plain_version(host_launch, name):
    env = ENVIRONMENTS[name]
    scs = [api.Scenario(profile=prof, datasets=ds, controller=c,
                        environment=env, total_s=20.0, dt=0.1)
           for prof, ds in ((CHAMELEON, FAST), (CLOUDLAB, ONE))
           for c in CONTROLLERS]
    prepared, groups = S._prepare_groups(scs, torch.device("cpu"))
    jitter = name == "lossy-wan"
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        args = (key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0)
        kw = dict(dt=key.dt, ctrl_every=key.ctrl_every)
        err, got = host_launch(*args, **kw)
        assert err == 0
        want = tl.tick_loop_reference(*args, **kw)
        for field, a, b in zip(["f32", "i32", *want[2]._fields],
                               [got[0], got[1], *got[2]],
                               [want[0], want[1], *want[2]]):
            if jitter and a.dtype == torch.float32:
                tol = JITTER_RTOL * max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= tol, (key, field)
            else:
                assert torch.equal(a, b), (name, key.ctrl_code, field)


def _random_policy(hidden, scale, seed):
    """Seeded numpy MLP weights ``1/sqrt(fan_in) * scale`` normal, biases
    0.1 normal: large scales make the heads move often."""
    rng = np.random.default_rng(seed)
    sizes = (9, *hidden, 9)
    params = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = (rng.normal(size=(n_in, n_out)) * scale
                           / np.sqrt(n_in)).astype(np.float32)
        params[f"b{i}"] = (rng.normal(size=n_out) * 0.1).astype(np.float32)
    return params


POLICIES = {"32x32": ((32, 32), 1.0), "32x32-x3": ((32, 32), 3.0),
            "64": ((64,), 2.0), "16x8x24": ((16, 8, 24), 2.0)}
BIG = (DatasetSpec("d", 100, 40000.0, 400.0),)


def _check_equal(host_launch, scs):
    prepared, groups = S._prepare_groups(scs, torch.device("cpu"))
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        args = (key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0)
        kw = dict(dt=key.dt, ctrl_every=key.ctrl_every)
        err, got = host_launch(*args, **kw)
        assert err == 0
        want = tl.tick_loop_reference(*args, **kw)
        for field, a, b in zip(["f32", "i32", *want[2]._fields],
                               [got[0], got[1], *got[2]],
                               [want[0], want[1], *want[2]]):
            assert torch.equal(a, b), (key.ctrl_code.name, field)
    return want


@pytest.mark.parametrize("env", ["reference", "dvfs-hp-race",
                                 "lossy-wan-loss", "logfit"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_learned_kernel_source_equals_plain_version(host_launch, policy,
                                                    env):
    from repro_torch.learn import LearnedController

    hidden, scale = POLICIES[policy]
    ctrl = LearnedController(params=_random_policy(hidden, scale, 0))
    scs = [api.Scenario(profile=prof, datasets=ds, controller=ctrl,
                        environment=ENVIRONMENTS[env], total_s=20.0, dt=0.1)
           for prof, ds in ((CHAMELEON, FAST), (CLOUDLAB, ONE),
                            (CHAMELEON, BIG))]
    want = _check_equal(host_launch, scs)
    # fsm counts the controller ticks the lanes ran
    assert int(want[1][:, 0].max()) >= 10


def test_launch_rejects_arguments_no_instance_takes(host_launch,
                                                    monkeypatch):
    sc = api.Scenario(profile=CHAMELEON, datasets=ONE, controller="EEMT",
                      environment=ENVIRONMENTS["dvfs-hp-race"], total_s=1.0)
    prepared, groups = S._prepare_groups([sc], torch.device("cpu"))
    (key, idxs), = groups.items()
    inp = S._stack_group(prepared, idxs, "cpu")
    prow, f0, i0 = engine.pack_batch(key.env_code, inp)
    spec = tl.kernel_spec(key.ctrl_code, key.env_code)[2]

    def call(codes):
        bad = spec._replace(codes=tuple(codes))
        monkeypatch.setattr(tl, "env_spec", lambda env: bad)
        return host_launch(key.ctrl_code, key.env_code, key.cpu, prow,
                           inp.bw, f0, i0, dt=key.dt,
                           ctrl_every=key.ctrl_every)[0]

    codes = dict(zip(tl.ENV_CODES, spec.codes))
    assert call(spec.codes) == 0
    for change in (dict(n_vf=1), dict(n_vf=tl.MAX_VF_POINTS + 1),
                   dict(network=3), dict(energy=-1),
                   dict(network=tl.NET_LOGFIT, n_bins=0)):
        assert call([{**codes, **change}[k] for k in tl.ENV_CODES]) != 0, \
            change


def test_launch_rejects_policies_no_instance_takes(host_launch,
                                                   monkeypatch):
    from repro_torch.learn import LearnedController

    ctrl = LearnedController()
    sc = api.Scenario(profile=CHAMELEON, datasets=ONE, controller=ctrl,
                      total_s=1.0)
    prepared, groups = S._prepare_groups([sc], torch.device("cpu"))
    (key, idxs), = groups.items()
    inp = S._stack_group(prepared, idxs, "cpu")
    prow, f0, i0 = engine.pack_batch(key.env_code, inp)

    table = torch.zeros(10000)
    monkeypatch.setattr(LearnedController, "table",
                        lambda self, device: table)

    def call(widths):
        monkeypatch.setattr(tl, "policy_widths", lambda c: tuple(widths))
        return host_launch(key.ctrl_code, key.env_code, key.cpu, prow,
                           inp.bw, f0, i0, dt=key.dt,
                           ctrl_every=key.ctrl_every)[0]

    assert call((9, 32, 32, 9)) == 0
    for widths in ((9, 32, 32, 8), (10, 32, 32, 9), (9, 65, 9),
                   (9, 8, 8, 8, 8, 9), (9, 0, 9)):
        assert call(widths) != 0, widths


# ------------------------------------------------------ the grouped launch --

def _jax_sweeps():
    """JAX scenarios of the sweeps the grouped launch is held on (the
    port's are their ``port_scenario``): the Figure 2 ``--smoke`` grid,
    the fig_dvfs and GreenDataFlow grids, a sweep mixing P 1 and 3 under
    the reference and lossy-wan environments, and a learned group beside
    EEMT."""
    from benchmarks import fig2 as jfig2
    from benchmarks import fig_dvfs as jfig
    from repro import api as japi
    from repro.core import types as jtypes
    from repro.learn import LearnedController as JLearned

    fast = (jtypes.DatasetSpec("a", 200, 400.0, 2.0),
            jtypes.DatasetSpec("b", 10, 600.0, 60.0),
            jtypes.DatasetSpec("e", 40, 300.0, 8.0))
    one = (jtypes.DatasetSpec("c", 50, 500.0, 10.0),)
    # one horizon per dataset count, or sweep pads P 1 to 3 itself
    mixed = [japi.Scenario(profile=prof, datasets=ds, controller=c,
                           environment=env, total_s=15.0 + 5 * len(ds),
                           dt=0.1)
             for prof in (jtypes.CHAMELEON, jtypes.CLOUDLAB)
             for ds in (fast, one)
             for env in (None, "lossy-wan")
             for c in ("EEMT", "ME", "wget/curl")]
    learned = JLearned(params=_random_policy((32, 32), 3.0, 1))
    learn = [japi.Scenario(profile=jtypes.CHAMELEON, datasets=ds,
                           controller=c, total_s=20.0, dt=0.1)
             for ds in (fast, one, fast[:1])
             for c in (learned, japi.make_controller("EEMT"))]
    return {
        "fig2-smoke": [c.scenario for c in
                       jfig2.experiment(smoke=True).cells()],
        "fig_dvfs": [c.scenario for c in jfig.experiment(smoke=False).cells()],
        "greendataflow": [c.scenario for c in jfig.greendataflow().cells()],
        "mixed-p-lossy-wan": mixed,
        "learned-eemt": learn,
    }


# The fig_dvfs and GreenDataFlow grids' cells keep everything but their
# horizon against the plain version on the CPU (~2 ms a tick a group):
# 30 s, 300 ticks.  The full horizons are held against the groups' own
# launches below.
PLAIN_HORIZON_S = {"fig_dvfs": 30.0, "greendataflow": 30.0}


def _port_sweep(name, **overrides):
    from torch_parity import port_scenario

    return [port_scenario(sc, **overrides) for sc in _jax_sweeps()[name]]


def _host_grouped(host_lib, calls):
    """A stand-in for ``tick_loop.tick_loop_grouped`` that launches the
    host build's kernel (``tick_loop.launch_groups``); each call appends
    (batches, launches) to ``calls``."""
    def run(batches):
        err, outs, launches = tl.launch_groups(
            host_lib, host_lib.host_tick_loop_grouped_launch, batches,
            stream=None)
        assert err == 0
        calls.append((len(batches), launches))
        return outs
    return run


def _run_grouped(host_lib, monkeypatch, scs):
    """``run_groups``' cuda path on the CPU: the host build's launches
    through ``engine.run_cuda_groups``.  Returns (keys, groups, prepared,
    outputs, calls)."""
    prepared, groups = S._prepare_groups(scs, torch.device("cpu"))
    keys = list(groups)
    calls = []
    monkeypatch.setattr(tl, "tick_loop_grouped", _host_grouped(host_lib,
                                                               calls))
    outs = engine.run_cuda_groups([
        (k.ctrl_code, k.env_code, k.cpu, k.dt, k.ctrl_every,
         S._stack_group(prepared, groups[k], "cpu")) for k in keys])
    return keys, groups, prepared, outs, calls


def _rows(key, sim, ts, metrics):
    lay = tickstate.TickLayout(key.n_partitions)
    return (*lay.pack_state(sim, ts), *metrics)


@pytest.mark.parametrize("name", ["fig2-smoke", "fig_dvfs", "greendataflow",
                                  "mixed-p-lossy-wan", "learned-eemt"])
def test_grouped_launch_equals_plain_version(host_lib, monkeypatch, name):
    """One launch per partition count runs every group of the sweep (one
    launch for all but the mixed sweep, which takes two); each group's
    final rows and seven traces equal the plain version's on the group
    alone, bit for bit (lossy-wan's jitter groups to JITTER_RTOL: the
    host's sinf)."""
    horizon = PLAIN_HORIZON_S.get(name)
    scs = _port_sweep(name, **({"total_s": horizon} if horizon else {}))
    keys, groups, prepared, outs, calls = _run_grouped(host_lib, monkeypatch,
                                                       scs)
    n_p = len({k.n_partitions for k in keys})
    assert calls == [(len(keys), n_p)] and len(keys) > 1
    assert n_p == (2 if name == "mixed-p-lossy-wan" else 1)
    for key, (sim, ts, m) in zip(keys, outs):
        inp = S._stack_group(prepared, groups[key], "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        f32, i32, wm = tl.tick_loop_reference(
            key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0,
            dt=key.dt, ctrl_every=key.ctrl_every)
        got = _rows(key, sim, ts, m)
        want = (f32, i32, *wm._replace(done=wm.done != 0))
        jitter = tl.env_spec(key.env_code).codes[3] == 1
        for field, a, b in zip(["f32", "i32", *wm._fields], got, want):
            if jitter and a.dtype == torch.float32:
                tol = JITTER_RTOL * max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= tol, (key, field)
            else:
                assert torch.equal(a, b), (name, key.ctrl_code.name, field)


@pytest.mark.parametrize("name", ["fig_dvfs", "greendataflow"])
def test_grouped_launch_equals_group_launches_at_full_horizon(
        host_lib, host_launch, monkeypatch, name):
    """The fig_dvfs and GreenDataFlow grids at their own horizons: the
    grouped launch equals each group's own launch bit for bit, final rows
    and seven traces."""
    scs = _port_sweep(name)
    keys, groups, prepared, outs, calls = _run_grouped(host_lib, monkeypatch,
                                                       scs)
    assert calls == [(len(keys), 1)]
    n_done = 0
    for key, (sim, ts, m) in zip(keys, outs):
        inp = S._stack_group(prepared, groups[key], "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        err, (f32, i32, wm) = host_launch(
            key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0,
            dt=key.dt, ctrl_every=key.ctrl_every)
        assert err == 0
        want = (f32, i32, *wm._replace(done=wm.done != 0))
        for field, a, b in zip(["f32", "i32", *wm._fields],
                               _rows(key, sim, ts, m), want):
            assert torch.equal(a, b), (name, key, field)
        n_done += int(m.done[:, -1].sum())
    assert n_done == len(scs)            # every transfer completed


@pytest.mark.parametrize("name", ["fig2-smoke", "fig_dvfs", "greendataflow",
                                  "mixed-p-lossy-wan", "learned-eemt"])
def test_group_count_still_equals_jax(name):
    """Grouping keeps the JAX package's meaning; only the launches per
    sweep change."""
    from repro import api as japi

    assert api.group_count(_port_sweep(name)) == japi.group_count(
        _jax_sweeps()[name])


def test_grouped_launch_rejects_what_it_cannot_take(host_lib):
    assert host_lib.tick_loop_max_groups() == tl.MAX_GROUPS
    sc = api.Scenario(profile=CHAMELEON, datasets=ONE, controller="EEMT",
                      total_s=1.0)
    prepared, groups = S._prepare_groups([sc], torch.device("cpu"))
    (key, idxs), = groups.items()
    inp = S._stack_group(prepared, idxs, "cpu")
    prow, f0, i0 = engine.pack_batch(key.env_code, inp)
    batch = (key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0,
             key.dt, key.ctrl_every)

    def launch(p, n_groups):
        return lambda _p, table, _n, stream: \
            host_lib.host_tick_loop_grouped_launch(p, table, n_groups, stream)

    # (3, 1): a P 1 descriptor in a P 3 launch
    for p, n in ((1, 1), (0, 1), (9, 1), (3, 1), (1, 0),
                 (1, tl.MAX_GROUPS + 1)):
        err, _ = tl.marshal_and_launch_groups(host_lib, launch(p, n),
                                              [batch], stream=None)
        assert (err == 0) == ((p, n) == (1, 1)), (p, n)
    err, _ = tl.marshal_and_launch_groups(host_lib, launch(1, 1),
                                          [batch] * (tl.MAX_GROUPS + 1),
                                          stream=None)
    assert err != 0                       # the descriptor table is full


def test_launch_groups_launches_once_per_partition_count(host_lib,
                                                         host_launch):
    """Batches of two partition counts, interleaved, and one of no lane:
    one launch per count, the outputs in the batches' order and each bit
    for bit the batch's own launch; the empty batch gets empty outputs and
    no launch."""
    scs = [api.Scenario(profile=CHAMELEON, datasets=ds, controller=c,
                        total_s=5.0 + len(ds), dt=0.1)
           for ds in (FAST, ONE) for c in ("EEMT", "ME")]
    prepared, groups = S._prepare_groups(scs, torch.device("cpu"))
    batches = []
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        batches.append((key.ctrl_code, key.env_code, key.cpu, prow, inp.bw,
                        f0, i0, key.dt, key.ctrl_every))
    assert [(b[3].shape[1] - 13) // 5 for b in batches] == [2, 2, 1, 1]
    batches = [batches[i] for i in (0, 2, 1, 3)]
    c, e, cpu, prow, bw, f0, i0, dt, ce = batches[1]
    batches.append((c, e, cpu, prow[:0], bw[:0], f0[:0], i0[:0], dt, ce))
    err, outs, launches = tl.launch_groups(
        host_lib, host_lib.host_tick_loop_grouped_launch, batches,
        stream=None)
    assert err == 0 and launches == 2
    for batch, got in zip(batches[:4], outs):
        c, e, cpu, prow, bw, f0, i0, dt, ce = batch
        err, want = host_launch(c, e, cpu, prow, bw, f0, i0, dt=dt,
                                ctrl_every=ce)
        assert err == 0
        for a, b in zip([got[0], got[1], *got[2]],
                        [want[0], want[1], *want[2]]):
            assert torch.equal(a, b)
    f32, i32, m = outs[4]
    assert f32.shape == (0, 11) and i32.shape == (0, 3)
    assert m.done.shape == (0, bw.shape[1])
