"""repro_torch.fleet against the JAX package's repro.fleet on the CPU.

Every test of tests/test_fleet.py has a counterpart here, and so have the
fleet cases of tests/test_environments.py, tests/test_dvfs.py,
tests/test_learn.py and tests/test_workloads.py: the same trace (made with
the JAX package's seeded numpy constructors, converted request by request)
goes through both packages' ``run_fleet``, and every per-transfer field,
the host statistics and ``(sim_s, waves, dropped)`` are held equal, bit
for bit.  The port runs its plain wave loop here (``devices=["cpu"]``);
the kernel's wave mode is held to it by tests/test_torch_wave.py (the
source built for the host) and on the card (tests/test_torch_fleet_gpu.py,
chip_smoke.py phase 20).

The goldens ``_GOLDEN`` (16 transfers) and ``FLEET_GOLDEN`` come from
jitted JAX; the port reproduces both bit for bit, ``total_energy_j`` and
``(sim_s, waves) == (130.0, 12)`` included.
"""
import dataclasses
import json
import math
import random

import numpy as np
import pytest

from repro import api as japi
from repro import fleet as jfleet
from repro.core.types import CHAMELEON, CLOUDLAB, CpuProfile, DatasetSpec
from repro_torch import api as tapi
from repro_torch import fleet as tfleet
from repro_torch.distributed import sharding as tshd
from test_environments import FLEET_GOLDEN
from test_fleet import _GOLDEN
from torch_parity import (port_cpu, port_datasets, port_environment,
                          port_profile, port_scenario)

FAST = (DatasetSpec("a", 200, 400.0, 2.0),
        DatasetSpec("b", 10, 600.0, 60.0))
ONE = (DatasetSpec("c", 50, 500.0, 10.0),)
BIG = (DatasetSpec("a", 2000, 4000.0, 2.0),
       DatasetSpec("b", 100, 6000.0, 60.0))
NO_CONTENTION = 1e9
CPU_DEV = ["cpu"]
# The port follows JAX's float32 semantics op by op; JAX's run_fleet runs
# jitted, and XLA contracts and reorders float32 ops, so energy and bytes
# of a live JAX report differ in the last bits (the standing tolerance
# against jitted JAX, PERF.md section 2).  The goldens are held exactly.
JIT_RTOL = 1e-5


def port_request(r):
    """The port's TransferRequest for a JAX one (controller converted as
    ``torch_parity.port_scenario`` converts a scenario's)."""
    ctrl = r.controller
    if not isinstance(ctrl, str):
        ctrl = port_scenario(japi.Scenario(
            profile=r.profile, datasets=r.datasets,
            controller=ctrl)).controller
    return tfleet.TransferRequest(
        arrival_s=r.arrival_s, datasets=port_datasets(r.datasets),
        controller=ctrl, profile=port_profile(r.profile), host=r.host,
        name=r.name, total_s=r.total_s, attempt=r.attempt)


def port_host(h):
    env = None if h.environment is None else port_environment(h.environment)
    return tfleet.Host(name=h.name, nic_mbps=h.nic_mbps, cpu=port_cpu(h.cpu),
                       slots=h.slots, environment=env)


def port_fleet(trace, hosts, **kw):
    return tfleet.run_fleet([port_request(r) for r in trace],
                            [port_host(h) for h in hosts], devices=CPU_DEV,
                            **kw)


def both(trace, hosts, **kw):
    """(JAX report, port report) of one trace on one pool."""
    return (jfleet.run_fleet(trace, hosts, **kw),
            port_fleet(trace, hosts, **kw))


def transfer_fields(t):
    return (t.name, t.controller, t.host, t.arrival_s, t.start_s, t.time_s,
            t.energy_j, t.moved_mb, t.completed, t.ideal_s)


def discrete_fields(t):
    """What the fleet decides: placement, admission, completion and
    duration — exact against jitted JAX."""
    return (t.name, t.controller, t.host, t.arrival_s, t.start_s, t.time_s,
            t.completed, t.ideal_s)


def close(a, b):
    return abs(a - b) <= JIT_RTOL * max(abs(a), abs(b))


def assert_same(jrep, trep):
    """The port's report against jitted JAX's: every transfer's placement,
    admission, completion and duration exact, its energy and bytes to
    ``JIT_RTOL`` (XLA fuses float32 ops, ROADMAP queue 3); the host stats
    and totals likewise; ``(sim_s, waves, dropped)`` exact."""
    assert [discrete_fields(t) for t in trep.transfers] == \
        [discrete_fields(t) for t in jrep.transfers]
    for t, j in zip(trep.transfers, jrep.transfers):
        assert close(t.energy_j, j.energy_j), (t.name, t.energy_j, j.energy_j)
        assert close(t.moved_mb, j.moved_mb), (t.name, t.moved_mb, j.moved_mb)
    for h, j in zip(trep.host_stats, jrep.host_stats):
        assert (h.name, h.busy_frac, h.peak_active) == \
            (j.name, j.busy_frac, j.peak_active)
        assert close(h.moved_mb, j.moved_mb) and close(h.nic_util, j.nic_util)
    assert len(trep.host_stats) == len(jrep.host_stats)
    assert (trep.sim_s, trep.waves, trep.dropped, trep.wave_s, trep.dt) == \
        (jrep.sim_s, jrep.waves, jrep.dropped, jrep.wave_s, jrep.dt)
    assert close(trep.total_energy_j, jrep.total_energy_j)


def assert_equal(a, b):
    """Two reports of the port, bit for bit."""
    assert [transfer_fields(t) for t in a.transfers] == \
        [transfer_fields(t) for t in b.transfers]
    assert [dataclasses.astuple(h) for h in a.host_stats] == \
        [dataclasses.astuple(h) for h in b.host_stats]
    assert a.summary() == b.summary()


def _by_name(report):
    return {t.name: t for t in report.transfers}


def _mk(name):
    if name == "eett":
        return japi.make_controller(name, target_tput_mbps=400.0)
    return japi.make_controller(name)


# ----------------------------------------------------------- equivalence --

ZERO_CASES = [
    ("t-eemt", FAST, japi.make_controller("eemt", max_ch=64)),
    ("t-me", ONE, japi.make_controller("me", max_ch=64)),
    ("t-static", FAST, "wget/curl"),
    ("t-big", BIG, japi.make_controller("eemt", max_ch=64)),
]


@pytest.fixture(scope="module")
def zero_contention():
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ds, controller=c,
                                   profile=CHAMELEON, name=n, total_s=600.0)
            for n, ds, c in ZERO_CASES]
    return both(reqs, jfleet.host_pool(1, nic_mbps=NO_CONTENTION),
                wave_s=5.0, dt=0.1)


def test_zero_contention_matches_independent_runs_bit_exactly(
        zero_contention):
    """N transfers on 1 uncontended host == N independent runs of the
    port's ``api.run``, and the whole report equals JAX's."""
    jrep, trep = zero_contention
    assert_same(jrep, trep)
    got = _by_name(trep)
    for n, ds, c in ZERO_CASES:
        sc = port_scenario(japi.Scenario(profile=CHAMELEON, datasets=ds,
                                         controller=c, total_s=600.0))
        solo = tapi.run(sc, device="cpu")
        ft = got[n]
        assert ft.completed and solo.completed
        assert ft.time_s == solo.time_s
        assert ft.energy_j == solo.energy_j
        assert ft.wait_s == 0.0


def test_permutation_invariance_without_names_or_distinct_totals():
    ds_a = (DatasetSpec("d", 50, 500.0, 10.0),)
    ds_b = (DatasetSpec("d", 5000, 500.0, 0.1),)
    hosts = (jfleet.Host("h0", nic_mbps=NO_CONTENTION),
             jfleet.Host("h1", nic_mbps=NO_CONTENTION,
                         cpu=CpuProfile(name="slow", num_cores=4)))
    r1 = jfleet.TransferRequest(arrival_s=0.0, datasets=ds_a,
                                controller="eemt", profile=CHAMELEON,
                                total_s=600.0)
    r2 = jfleet.TransferRequest(arrival_s=0.0, datasets=ds_b,
                                controller="eemt", profile=CHAMELEON,
                                total_s=600.0)
    ja, a = both([r1, r2], hosts, wave_s=5.0, dt=0.1)
    b = port_fleet([r2, r1], hosts, wave_s=5.0, dt=0.1)
    assert_same(ja, a)
    assert a.total_energy_j == b.total_energy_j
    assert [t.energy_j for t in a.transfers] == \
        [t.energy_j for t in b.transfers]


def test_arrival_order_permutation_leaves_energy_unchanged():
    trace = jfleet.poisson_trace(rate_per_s=0.5, n_transfers=24,
                                 datasets=[ONE, FAST, BIG],
                                 controllers=("eemt", "me", "wget/curl"),
                                 profile=CHAMELEON, seed=7, total_s=600.0)
    hosts = jfleet.host_pool(3, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    ja, a = both(trace, hosts, wave_s=10.0, dt=0.1)
    assert_same(ja, a)
    shuffled = list(trace)
    random.Random(123).shuffle(shuffled)
    b = port_fleet(shuffled, hosts, wave_s=10.0, dt=0.1)
    assert a.total_energy_j == b.total_energy_j
    assert [transfer_fields(t) for t in a.transfers] == \
        [transfer_fields(t) for t in b.transfers]


# ------------------------------------------------------------ contention --

def test_nic_contention_slows_transfers_down():
    pool = jfleet.host_pool(1, nic_mbps=CHAMELEON.bandwidth_mbps)
    jsolo, solo = both(
        [jfleet.TransferRequest(arrival_s=0.0, datasets=BIG,
                                controller="eemt", profile=CHAMELEON,
                                name="solo", total_s=600.0)],
        pool, wave_s=5.0, dt=0.1)
    jboth, both_ = both(
        [jfleet.TransferRequest(arrival_s=0.0, datasets=BIG,
                                controller="eemt", profile=CHAMELEON,
                                name=f"c{i}", total_s=600.0)
         for i in range(2)], pool, wave_s=5.0, dt=0.1)
    assert_same(jsolo, solo)
    assert_same(jboth, both_)
    t_solo = solo.transfers[0].time_s
    for t in both_.transfers:
        assert t.completed
        assert t.time_s > t_solo


def test_slots_queue_admissions():
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                   controller="wget/curl", profile=CHAMELEON,
                                   name=f"q{i}", total_s=600.0)
            for i in range(2)]
    jrep, rep = both(reqs, jfleet.host_pool(1, nic_mbps=NO_CONTENTION,
                                            slots=1), wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    waits = sorted(t.wait_s for t in rep.transfers)
    assert waits[0] == 0.0
    assert waits[1] >= 5.0
    assert all(t.completed for t in rep.transfers)


def test_host_pinning_and_assignment():
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                   controller="wget/curl", profile=CHAMELEON,
                                   host=1, name="pinned", total_s=600.0),
            jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                   controller="wget/curl", profile=CHAMELEON,
                                   name="free", total_s=600.0)]
    jrep, rep = both(reqs, jfleet.host_pool(2, nic_mbps=NO_CONTENTION),
                     wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    got = _by_name(rep)
    assert got["pinned"].host == "host-1"
    assert got["free"].host == "host-0"
    bad = [jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                  controller="wget/curl", profile=CHAMELEON,
                                  host=7)]
    with pytest.raises(ValueError):
        jfleet.run_fleet(bad, jfleet.host_pool(2), wave_s=5.0, dt=0.1)
    with pytest.raises(ValueError):
        port_fleet(bad, jfleet.host_pool(2), wave_s=5.0, dt=0.1)


def test_budget_timeout_marks_incomplete():
    req = jfleet.TransferRequest(arrival_s=0.0, datasets=BIG,
                                 controller="wget/curl", profile=CLOUDLAB,
                                 name="slow", total_s=10.0)
    jrep, rep = both([req], jfleet.host_pool(1, nic_mbps=NO_CONTENTION),
                     wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    t = rep.transfers[0]
    assert not t.completed
    assert t.moved_mb > 0.0
    assert t.energy_j > 0.0
    parsed = json.loads(rep.to_json())
    assert parsed["slowdown"]["p99"] is None
    assert set(parsed) == set(json.loads(jrep.to_json()))


def test_horizon_cut_reports_dropped():
    trace = jfleet.poisson_trace(rate_per_s=1.0, n_transfers=20,
                                 datasets=[ONE], controllers=["wget/curl"],
                                 profile=CHAMELEON, seed=3, total_s=600.0)
    jrep, rep = both(trace, jfleet.host_pool(1, nic_mbps=NO_CONTENTION,
                                             slots=1),
                     wave_s=5.0, dt=0.1, horizon_s=10.0)
    assert_same(jrep, rep)
    assert rep.dropped > 0
    assert len(rep.transfers) + rep.dropped == len(trace)


# ------------------------------------------------------------ trace APIs --

def test_poisson_trace_is_deterministic():
    kw = dict(rate_per_s=2.0, n_transfers=50, datasets=[ONE, FAST],
              controllers=("eemt", "me"), seed=42)
    a = tfleet.poisson_trace(profile=port_profile(CHAMELEON),
                             **{**kw, "datasets": [port_datasets(d)
                                                   for d in kw["datasets"]]})
    j = jfleet.poisson_trace(profile=CHAMELEON, **kw)
    assert a == tuple(port_request(r) for r in j)
    b = tfleet.poisson_trace(profile=port_profile(CHAMELEON),
                             **{**kw, "datasets": [port_datasets(d)
                                                   for d in kw["datasets"]]})
    assert a == b and len(a) == 50
    arrivals = [r.arrival_s for r in a]
    assert arrivals == sorted(arrivals)


def test_replay_trace_roundtrip_and_validation():
    prof, cl = port_profile(CHAMELEON), port_profile(CLOUDLAB)
    recs = [{"arrival_s": 0.0, "datasets": port_datasets(ONE),
             "controller": "me"},
            {"arrival_s": 3.0, "datasets": port_datasets(FAST),
             "controller": "eemt", "profile": cl, "host": 0}]
    trace = tfleet.replay_trace(recs, profile=prof)
    assert trace[0].profile is prof
    assert trace[1].profile is cl
    jtrace = jfleet.replay_trace(
        [{"arrival_s": 0.0, "datasets": ONE, "controller": "me"},
         {"arrival_s": 3.0, "datasets": FAST, "controller": "eemt",
          "profile": CLOUDLAB, "host": 0}], profile=CHAMELEON)
    assert trace == tuple(port_request(r) for r in jtrace)
    with pytest.raises(ValueError):
        tfleet.replay_trace([{"arrival_s": 0.0, "datasets": ONE,
                              "controller": "me", "bogus_column": 1}],
                            profile=prof)
    with pytest.raises(ValueError):
        tfleet.replay_trace([{"arrival_s": 0.0, "datasets": ONE,
                              "controller": "me"}])


@pytest.mark.parametrize("maker", ["poisson", "diurnal", "replay"])
def test_streams_equal_jax(maker):
    kw = dict(datasets=[ONE, FAST], controllers=("eemt", "me"), seed=9,
              n_transfers=40)
    tkw = dict(kw, datasets=[port_datasets(d) for d in kw["datasets"]],
               profile=port_profile(CHAMELEON))
    if maker == "poisson":
        j = list(jfleet.poisson_stream(rate_per_s=2.0, profile=CHAMELEON,
                                       **kw))
        t = list(tfleet.poisson_stream(rate_per_s=2.0, **tkw))
    elif maker == "diurnal":
        d = dict(base_rate_per_s=0.5, peak_rate_per_s=4.0, period_s=60.0)
        j = list(jfleet.diurnal_stream(profile=CHAMELEON, **d, **kw))
        t = list(tfleet.diurnal_stream(**d, **tkw))
    else:
        trace = jfleet.poisson_trace(rate_per_s=2.0, profile=CHAMELEON, **kw)
        j = list(jfleet.replay_stream(trace))
        t = list(tfleet.replay_stream(port_request(r) for r in trace))
        with pytest.raises(ValueError):
            list(tfleet.replay_stream(reversed(t)))
    assert t == [port_request(r) for r in j]


# ------------------------------------------------------------ aggregates --

def test_report_aggregates_and_json():
    trace = jfleet.poisson_trace(rate_per_s=1.0, n_transfers=12,
                                 datasets=[ONE, FAST],
                                 controllers=("eemt", "wget/curl"),
                                 profile=CHAMELEON, seed=5, total_s=600.0)
    jrep, rep = both(trace, jfleet.host_pool(
        2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4), wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    s = rep.summary()
    assert s["transfers"] == 12
    assert sum(row["transfers"] for row in s["by_controller"].values()) == 12
    assert s["total_energy_j"] == pytest.approx(
        sum(t.energy_j for t in rep.transfers))
    assert 0.0 < s["joules_per_gb"] < 1e4
    sd = s["slowdown"]
    assert sd["p50"] <= sd["p95"] <= sd["p99"]
    for h in rep.host_stats:
        assert 0.0 <= h.busy_frac <= 1.0
        assert h.peak_active <= 4
    parsed = json.loads(rep.to_json(wall_s=1.0))
    assert parsed["wall_s"] == 1.0 and parsed["transfers"] == 12
    assert set(parsed) == set(json.loads(jrep.to_json(wall_s=1.0)))


def test_api_reexports_fleet_entry_points():
    assert tapi.run_fleet is tfleet.run_fleet
    assert tapi.host_pool is tfleet.host_pool
    assert tapi.TransferRequest is tfleet.TransferRequest
    assert japi.run_fleet is jfleet.run_fleet


def test_empty_trace():
    jrep, rep = both([], jfleet.host_pool(2, nic_mbps=NO_CONTENTION),
                     wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    assert len(rep.transfers) == 0
    assert rep.sim_s == 0.0 and rep.waves == 0 and rep.dropped == 0
    assert rep.total_energy_j == 0.0
    json.loads(rep.to_json())


def test_trace_shorter_than_one_wave():
    req = jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                 controller="wget/curl", profile=CHAMELEON,
                                 name="tiny", total_s=600.0)
    jrep, rep = both([req], jfleet.host_pool(1, nic_mbps=NO_CONTENTION),
                     wave_s=30.0, dt=0.1)
    assert_same(jrep, rep)
    t = rep.transfers[0]
    assert t.completed and t.time_s < 30.0
    assert rep.waves == 1


def golden_trace():
    return jfleet.poisson_trace(
        rate_per_s=0.5, n_transfers=16,
        datasets=[ONE, FAST, (DatasetSpec("a", 2000, 4000.0, 2.0),)],
        controllers=("eemt", "me", "wget/curl"), profile=CHAMELEON,
        seed=1810, total_s=600.0)


def test_offline_golden_cells_bit_exact():
    """``_GOLDEN`` (jitted JAX, tests/test_fleet.py) bit for bit."""
    rep = port_fleet(golden_trace(),
                     jfleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps,
                                      slots=4),
                     wave_s=10.0, dt=0.5)
    got = _by_name(rep)
    assert set(got) == set(_GOLDEN)
    for name, (energy, time_s, start_s, host, done) in _GOLDEN.items():
        t = got[name]
        assert (t.energy_j, t.time_s, t.start_s, t.host, t.completed) == \
            (energy, time_s, start_s, host, done), name
    assert rep.total_energy_j == math.fsum(v[0] for v in _GOLDEN.values())
    assert (rep.sim_s, rep.waves) == (130.0, 12)


def test_heterogeneous_cpu_pools_group_separately():
    cpus = (CpuProfile(), CpuProfile(name="slow", num_cores=4))
    hosts = (jfleet.Host("h0", nic_mbps=NO_CONTENTION, cpu=cpus[0]),
             jfleet.Host("h1", nic_mbps=NO_CONTENTION, cpu=cpus[1]))
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                   controller="eemt", profile=CHAMELEON,
                                   host=i, name=f"h{i}", total_s=600.0)
            for i in range(2)]
    jrep, rep = both(reqs, hosts, wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    assert all(t.completed for t in rep.transfers)


def test_lanes_split_over_devices_change_nothing():
    """Two devices (both the CPU here): each group's lanes padded with
    drained zero lanes and split over them; the report is unchanged."""
    trace = jfleet.poisson_trace(rate_per_s=1.0, n_transfers=12,
                                 datasets=[ONE, FAST],
                                 controllers=("eemt", "wget/curl"),
                                 profile=CHAMELEON, seed=5, total_s=600.0)
    hosts = jfleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    one = port_fleet(trace, hosts, wave_s=5.0, dt=0.1)
    two = tfleet.run_fleet([port_request(r) for r in trace],
                           [port_host(h) for h in hosts], wave_s=5.0,
                           dt=0.1, devices=["cpu", "cpu"])
    assert_equal(one, two)


def test_each_device_resolves_its_own_executor(monkeypatch):
    """A pool of a CPU and a card under ``auto``: the CPU's share runs the
    plain wave and the card's share goes through the tick kernel's wave
    mode (``engine.run_cuda_wave_groups``), never the plain loop.  Here the
    card is a stand-in: its rows stay on the CPU and its launches run the
    plain wave.  ``cuda`` asked of a pool with a CPU raises."""
    import torch

    from repro_torch.core import engine as tengine
    from repro_torch.fleet import scheduler as tsched
    from repro_torch.kernels import tick_loop as tl

    trace = jfleet.poisson_trace(rate_per_s=1.0, n_transfers=12,
                                 datasets=[ONE, FAST],
                                 controllers=("eemt", "wget/curl"),
                                 profile=CHAMELEON, seed=5, total_s=600.0)
    hosts = jfleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    one = port_fleet(trace, hosts, wave_s=5.0, dt=0.1)
    to_device, plain_runner = tsched._to_device, tengine.get_wave_runner
    moved, launched, plain = [], [], []

    def on_cpu(dev, items):
        moved.append(torch.device(dev).type)
        return to_device("cpu", items)

    def card(waves):
        launched.append(len(waves))
        return tl.tick_wave_grouped(waves)

    def runner(*a):
        plain.append(moved[-1])
        return plain_runner(*a)

    monkeypatch.setattr(tsched, "resolve_device", torch.device)
    monkeypatch.setattr(tsched, "_to_device", on_cpu)
    monkeypatch.setattr(tengine, "run_cuda_wave_groups", card)
    monkeypatch.setattr(tengine, "get_wave_runner", runner)
    two = tfleet.run_fleet([port_request(r) for r in trace],
                           [port_host(h) for h in hosts], wave_s=5.0,
                           dt=0.1, devices=["cpu", "cuda"])
    assert_equal(one, two)
    assert launched and len(launched) == moved.count("cuda")
    assert plain and set(plain) == {"cpu"}
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tfleet.run_fleet([port_request(r) for r in trace],
                         [port_host(h) for h in hosts], wave_s=5.0, dt=0.1,
                         devices=["cuda", "cpu"], executor="cuda")


def test_sharding_helpers(monkeypatch):
    rows = (np.arange(10, dtype=np.float32).reshape(5, 2),
            np.arange(5, dtype=np.int32))
    padded, b = tshd.pad_batch(rows, 4, fill="zero")
    assert b == 5 and padded[0].shape == (8, 2) and padded[1][5:].sum() == 0
    rep, _ = tshd.pad_batch(rows, 4)
    assert (rep[1][5:] == 4).all()
    mesh = tshd.batch_mesh(["cpu", "cpu"])
    shards = tshd.shard_batch(padded, mesh)
    assert len(shards) == 2 and shards[0][0].shape == (4, 2)
    assert np.array_equal(np.concatenate([s[1].numpy() for s in shards]),
                          padded[1])
    with pytest.raises(ValueError):
        tshd.split_batch(rows, 2)
    with pytest.raises(ValueError):
        tshd.pad_batch(rows, 2, fill="nan")
    with pytest.raises(ValueError):
        tshd.MeshConfig(num_hosts=0)
    monkeypatch.setattr(tshd, "local_devices", lambda: mesh + mesh)
    assert tshd.MeshConfig(num_hosts=1, devices_per_host=2).mesh() == mesh
    assert len(tshd.MeshConfig().devices()) == 4
    with pytest.raises(ValueError):
        tshd.MeshConfig(num_hosts=3, devices_per_host=2).devices()


# ------------------------------- fleet cases of the other reference tests --

def test_reference_environment_matches_fleet_golden():
    """tests/test_environments.py's FLEET_GOLDEN, bit for bit."""
    req = jfleet.TransferRequest(arrival_s=0.0, datasets=FAST,
                                 controller=_mk("eemt"), profile=CHAMELEON,
                                 name="g", total_s=240.0)
    jrep, rep = both([req], jfleet.host_pool(1, nic_mbps=NO_CONTENTION),
                     wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    t = rep.transfers[0]
    assert (t.completed, t.time_s, t.energy_j, t.moved_mb) == FLEET_GOLDEN


def test_matched_dvfs_tables_match_fleet_golden():
    """tests/test_dvfs.py::test_matched_tables_match_fleet_golden."""
    matched = japi.Environment(network=japi.DvfsNetworkModel(),
                               energy=japi.DvfsEnergyModel.matched(
                                   CpuProfile()))
    req = jfleet.TransferRequest(arrival_s=0.0, datasets=FAST,
                                 controller=_mk("eemt"), profile=CHAMELEON,
                                 name="g", total_s=240.0)
    hosts = (jfleet.Host("h", nic_mbps=NO_CONTENTION, environment=matched),)
    jrep, rep = both([req], hosts, wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    t = rep.transfers[0]
    assert (t.completed, t.time_s, t.energy_j, t.moved_mb) == FLEET_GOLDEN


def test_heterogeneous_fleet_environments_complete_and_differ():
    """tests/test_environments.py:386-413: reference / lossy-wan /
    big-little hosts, pinned identical requests: JAX's report, and each
    lane equal to the port's ``api.run`` of its environment bit for bit."""
    hosts = (jfleet.Host("ref", nic_mbps=NO_CONTENTION),
             jfleet.Host("wan", nic_mbps=NO_CONTENTION,
                         environment="lossy-wan"),
             jfleet.Host("edge", nic_mbps=NO_CONTENTION,
                         environment="big-little"))
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=FAST,
                                   controller=_mk("eemt"), profile=CHAMELEON,
                                   host=i, name=h.name, total_s=600.0)
            for i, h in enumerate(hosts)]
    jrep, rep = both(reqs, hosts, wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    got = _by_name(rep)
    assert all(t.completed for t in got.values())
    solo_ref = tapi.run(tapi.Scenario(
        profile=port_profile(CHAMELEON), datasets=port_datasets(FAST),
        controller=port_request(reqs[0]).controller, total_s=600.0),
        device="cpu")
    assert got["ref"].energy_j == solo_ref.energy_j
    assert got["wan"].energy_j > got["ref"].energy_j
    assert got["edge"].energy_j != got["ref"].energy_j
    for name, env in (("wan", "lossy-wan"), ("edge", "big-little")):
        solo = tapi.run(tapi.Scenario(
            profile=port_profile(CHAMELEON), datasets=port_datasets(FAST),
            controller=port_request(reqs[0]).controller, environment=env,
            total_s=600.0, dt=0.1), device="cpu")
        assert got[name].time_s == solo.time_s
        assert got[name].energy_j == solo.energy_j


def test_heterogeneous_fleet_unpinned_trace_completes():
    """tests/test_environments.py:415-432: combos created lazily for late
    (cpu, environment) pairs pad and run as in JAX."""
    hosts = (jfleet.Host("h0", nic_mbps=NO_CONTENTION, slots=1),
             jfleet.Host("h1", nic_mbps=NO_CONTENTION, slots=1,
                         environment="lossy-wan"),
             jfleet.Host("h2", nic_mbps=NO_CONTENTION, slots=1,
                         environment=japi.Environment(
                             energy=japi.BigLittleEnergyModel(n_big=2))))
    trace = jfleet.poisson_trace(rate_per_s=1.0, n_transfers=9,
                                 datasets=[FAST, ONE],
                                 controllers=("eemt", "wget/curl"),
                                 profile=CHAMELEON, seed=11, total_s=600.0)
    jrep, rep = both(trace, hosts, wave_s=5.0, dt=0.1)
    assert_same(jrep, rep)
    assert len(rep.transfers) == 9
    assert all(t.completed for t in rep.transfers)
    assert rep.dropped == 0


def test_host_pool_threads_environment():
    pool = tfleet.host_pool(3, environment="lossy-wan")
    assert all(h.environment == "lossy-wan" for h in pool)
    assert [dataclasses.astuple(port_host(h)) for h in
            jfleet.host_pool(3, slots=2)] == \
        [dataclasses.astuple(h) for h in tfleet.host_pool(3, slots=2)]
    with pytest.raises(ValueError):
        tfleet.host_pool(0)
    with pytest.raises(ValueError):
        tfleet.Host("x", nic_mbps=0.0)


def test_learned_through_fleet():
    """tests/test_learn.py::test_learned_through_fleet: the learned lane
    equals the port's ``api.run`` bit for bit, and the report JAX's (the
    policy's logits agree to 1.2e-6, tests/test_torch_learn.py; no action
    here is a near tie)."""
    import jax

    from repro import learn as jlearn
    from repro.learn.controller import LearnedController as JLearned
    c = JLearned(params=jlearn.init_policy(jlearn.PolicyConfig(),
                                           jax.random.PRNGKey(0)))
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=FAST,
                                   controller=c, profile=CHAMELEON,
                                   name="lrn", total_s=240.0),
            jfleet.TransferRequest(arrival_s=1.0, datasets=ONE,
                                   controller=_mk("eemt"), profile=CHAMELEON,
                                   name="heur", total_s=240.0)]
    hosts = jfleet.host_pool(2, nic_mbps=NO_CONTENTION)
    jrep, rep = both(reqs, hosts, wave_s=5.0, dt=0.1)
    assert "learned" in rep.by_controller()
    got = _by_name(rep)
    assert got["lrn"].moved_mb > 0
    assert_same(jrep, rep)
    tc = port_request(reqs[0]).controller
    solo = tapi.run(tapi.Scenario(profile=port_profile(CHAMELEON),
                                  datasets=port_datasets(FAST),
                                  controller=tc, total_s=240.0, dt=0.1),
                    device="cpu")
    assert got["lrn"].time_s == solo.time_s
    assert got["lrn"].energy_j == solo.energy_j


def test_logfit_constant_schedule_is_bitexact_noop():
    """tests/test_workloads.py::test_logfit_constant_schedule_is_bitexact_
    noop through the port's ``run_fleet``, and both fleets equal JAX's."""
    from repro.workloads.logfit import LogRecord, logfit_environment
    bw = CHAMELEON.bandwidth_mbps
    recs = [LogRecord(start_s=k * 60.0, end_s=(k + 1) * 60.0, mb=bw * 60.0,
                      rtt_s=0.05) for k in range(3)]
    env = logfit_environment(recs)
    assert env.network.bw_mbps == (bw, bw, bw)
    model = dataclasses.replace(env.network, rtt_s=None)
    trace = jfleet.poisson_trace(rate_per_s=0.5, n_transfers=4,
                                 datasets=[ONE, FAST],
                                 controllers=("eemt", "wget/curl"),
                                 profile=CHAMELEON, seed=4, total_s=600.0)
    jref, ref = both(trace, jfleet.host_pool(2, slots=4), wave_s=10.0,
                     dt=0.5)
    jfit, fit = both(trace, jfleet.host_pool(2, slots=4, environment=model),
                     wave_s=10.0, dt=0.5)
    assert_same(jref, ref)
    assert_same(jfit, fit)
    assert fit.transfers == ref.transfers


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """No module of src/repro_torch/ and nothing of chip_smoke.py imports
    ``jax`` or ``repro`` (a grep of the sources)."""
    import os
    import re
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert len(files) > 80 and not hits, hits
