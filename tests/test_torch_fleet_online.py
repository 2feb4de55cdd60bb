"""repro_torch.fleet.run_fleet_online against the port's own offline fleet
and the JAX package's online fleet, on the CPU.

Every case of tests/test_fleet_online.py has a counterpart here: the same
trace (made with the JAX package's seeded constructors, converted request
by request) goes through

* the port's ``run_fleet_online`` and the port's ``run_fleet``, held bit
  for bit (per-transfer records, exact totals, ``(sim_s, waves)``), as JAX
  holds its online loop to its offline one;
* the JAX package's ``run_fleet_online``, which runs jitted waves: every
  transfer's placement, start, completion and time, the counters and
  ``(sim_s, waves, dropped)`` exact, energy and bytes to ``JIT_RTOL``
  (tests/test_torch_fleet.py).

The port runs its plain wave loop here (``devices=("cpu",)``).  The card's
route (every occupied pool of a wave in one launch of the tick kernel's
wave mode) is rehearsed with a stand-in card, and held to the plain loop on
the card by tests/test_torch_fleet_online_gpu.py and chip_smoke.py phase
21.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.core.types import CHAMELEON, DatasetSpec
from repro_torch import api as tapi
from repro_torch import fleet as tfleet
from repro_torch.distributed import sharding as tshd
from test_torch_fleet import (close, discrete_fields, port_host,
                              port_request, transfer_fields)

FAST = (DatasetSpec("a", 200, 400.0, 2.0),
        DatasetSpec("b", 10, 600.0, 60.0))
ONE = (DatasetSpec("c", 50, 500.0, 10.0),)
NO_CONTENTION = 1e9
CPU = ("cpu",)

HOSTS = dict(nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)


def _trace(n=24, seed=11):
    return jfleet.poisson_trace(rate_per_s=0.5, n_transfers=n,
                                datasets=[ONE, FAST],
                                controllers=("eemt", "me", "wget/curl"),
                                profile=CHAMELEON, seed=seed, total_s=600.0)


def port_online(stream, hosts, **kw):
    kw.setdefault("devices", CPU)
    return tfleet.run_fleet_online([port_request(r) for r in stream],
                                   [port_host(h) for h in hosts], **kw)


def port_offline(trace, hosts, **kw):
    return tfleet.run_fleet([port_request(r) for r in trace],
                            [port_host(h) for h in hosts], devices=["cpu"],
                            **kw)


def online_both(stream, hosts, **kw):
    """(JAX's online report, the port's) of one stream on one pool."""
    stream = list(stream)
    return (jfleet.run_fleet_online(stream, hosts, **kw),
            port_online(stream, hosts, **kw))


def assert_online_same(jrep, trep):
    """The port's online report against jitted JAX's: the fold's counts,
    the counters and ``(sim_s, waves, dropped)`` exact; totals and host
    stats to ``JIT_RTOL``; per-transfer records (when tracked) as
    tests/test_torch_fleet.py::assert_same holds them."""
    assert (trep.fold.transfers, trep.completed, trep.sim_s, trep.waves,
            trep.dropped, trep.wave_s, trep.dt) == \
        (jrep.fold.transfers, jrep.completed, jrep.sim_s, jrep.waves,
         jrep.dropped, jrep.wave_s, jrep.dt)
    assert trep.counters == jrep.counters
    assert close(trep.total_energy_j, jrep.total_energy_j)
    assert close(trep.total_gb, jrep.total_gb)
    for h, j in zip(trep.host_stats, jrep.host_stats):
        assert (h.name, h.busy_frac, h.peak_active) == \
            (j.name, j.busy_frac, j.peak_active)
        assert close(h.moved_mb, j.moved_mb) and close(h.nic_util, j.nic_util)
    assert len(trep.host_stats) == len(jrep.host_stats)
    assert (trep.transfers is None) == (jrep.transfers is None)
    if trep.transfers is not None:
        assert [discrete_fields(t) for t in trep.transfers] == \
            [discrete_fields(t) for t in jrep.transfers]
        for t, j in zip(trep.transfers, jrep.transfers):
            assert close(t.energy_j, j.energy_j), (t.name, t.energy_j,
                                                   j.energy_j)
            assert close(t.moved_mb, j.moved_mb), (t.name, t.moved_mb,
                                                   j.moved_mb)
    assert set(trep.by_controller()) == set(jrep.by_controller())
    for name, row in trep.by_controller().items():
        jrow = jrep.by_controller()[name]
        assert (row["transfers"], row["completed"]) == \
            (jrow["transfers"], jrow["completed"])
    assert trep.slowdowns() == jrep.slowdowns()


def assert_online_equal(a, b):
    """Two online reports of the port, bit for bit."""
    assert [transfer_fields(t) for t in a.transfers] == \
        [transfer_fields(t) for t in b.transfers]
    assert a.summary() == b.summary()


# ---------------------------------------------------------------- parity --

def test_online_matches_offline_bit_exactly_on_shared_trace():
    """Same trace, generous capacity: per-transfer records identical to
    the port's offline fleet, and the report JAX's online one."""
    trace = _trace()
    hosts = jfleet.host_pool(2, **HOSTS)
    off = port_offline(trace, hosts, wave_s=10.0, dt=0.5)
    jon, on = online_both(trace, hosts, wave_s=10.0, dt=0.5,
                          pool_capacity=64, track_transfers=True)
    assert_online_same(jon, on)

    assert on.fold.transfers == len(off.transfers) == len(trace)
    got = {t.name: t for t in on.transfers}
    for t in off.transfers:
        assert got[t.name] == t          # frozen dataclass: bit-exact
    # Exact streaming totals == offline fsum totals, no tolerance.
    assert on.total_energy_j == off.total_energy_j
    assert on.total_gb == off.total_gb
    assert on.completed == off.completed
    assert on.sim_s == off.sim_s
    assert on.waves == off.waves
    assert on.dropped == 0

    ob, nb = off.by_controller(), on.by_controller()
    assert set(ob) == set(nb)
    for name in ob:
        for key in ("transfers", "completed", "energy_j", "gb",
                    "joules_per_gb", "mean_time_s", "mean_wait_s"):
            assert nb[name][key] == ob[name][key], (name, key)


def test_online_percentiles_within_sketch_tolerance():
    trace = _trace(n=48, seed=12)
    hosts = jfleet.host_pool(2, **HOSTS)
    off = port_offline(trace, hosts, wave_s=10.0, dt=0.5)
    jon, on = online_both(trace, hosts, wave_s=10.0, dt=0.5,
                          pool_capacity=64)
    assert_online_same(jon, on)
    vals = np.asarray([t.slowdown for t in off.transfers if t.completed])
    sketch = on.slowdowns()
    for q, key in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
        ref = float(np.percentile(vals, 100 * q, method="inverted_cdf"))
        assert abs(sketch[key] - ref) <= 0.0101 * ref + 1e-12, (key, ref)


def test_bounded_pool_preserves_exact_totals():
    """Recycling through a 1-slot pool delays admissions but changes
    nothing a transfer consumes once admitted: totals still exact."""
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                   controller="wget/curl", profile=CHAMELEON,
                                   name=f"r{i}", total_s=600.0)
            for i in range(8)]
    hosts = jfleet.host_pool(1, nic_mbps=NO_CONTENTION)
    jbig, big = online_both(reqs, hosts, wave_s=5.0, dt=0.1,
                            pool_capacity=64)
    jsmall, small = online_both(reqs, hosts, wave_s=5.0, dt=0.1,
                                pool_capacity=1)
    assert_online_same(jbig, big)
    assert_online_same(jsmall, small)
    assert small.completed == big.completed == 8
    assert small.counters["recycled_slots"] >= 7
    assert small.counters["peak_queue_depth"] >= 7
    assert small.total_energy_j == big.total_energy_j
    assert small.total_gb == big.total_gb
    assert small.sim_s > big.sim_s        # serialization costs time


# ------------------------------------------------------------ edge cases --

def test_empty_stream():
    jrep, rep = online_both(iter(()), jfleet.host_pool(2, **HOSTS))
    assert_online_same(jrep, rep)
    assert rep.fold.transfers == 0
    assert rep.waves == 0 and rep.sim_s == 0.0 and rep.dropped == 0
    assert rep.slowdowns() == {"p50": None, "p95": None, "p99": None}
    assert set(json.loads(rep.to_json())) == set(json.loads(jrep.to_json()))


def test_stream_shorter_than_one_wave():
    req = jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                 controller="wget/curl", profile=CHAMELEON,
                                 name="tiny", total_s=600.0)
    hosts = jfleet.host_pool(1, nic_mbps=NO_CONTENTION)
    off = port_offline([req], hosts, wave_s=30.0, dt=0.1)
    jon, on = online_both([req], hosts, wave_s=30.0, dt=0.1,
                          track_transfers=True)
    assert_online_same(jon, on)
    assert on.transfers[0] == off.transfers[0]
    assert on.total_energy_j == off.total_energy_j
    assert on.waves == 1


def test_all_drained_final_wave_counters_balance():
    jrep, rep = online_both(_trace(n=12), jfleet.host_pool(2, **HOSTS),
                            wave_s=10.0, dt=0.5)
    assert_online_same(jrep, rep)
    c = rep.counters
    assert c["admitted"] == c["retired"] == rep.fold.transfers == 12
    assert rep.dropped == 0
    assert c["waves_run"] == rep.waves >= 1
    assert c["peak_in_flight"] >= 1


def test_idle_gap_fast_forwards_to_next_arrival():
    reqs = [jfleet.TransferRequest(arrival_s=t, datasets=ONE,
                                   controller="wget/curl", profile=CHAMELEON,
                                   name=f"g{i}", total_s=600.0)
            for i, t in enumerate((0.0, 10_000.0))]
    jrep, rep = online_both(reqs, jfleet.host_pool(1,
                                                   nic_mbps=NO_CONTENTION),
                            wave_s=5.0, dt=0.1)
    assert_online_same(jrep, rep)
    assert rep.completed == 2
    assert rep.sim_s > 10_000.0
    assert rep.waves < 20


def test_horizon_cut_reports_dropped():
    trace = jfleet.poisson_trace(rate_per_s=1.0, n_transfers=20,
                                 datasets=[ONE], controllers=["wget/curl"],
                                 profile=CHAMELEON, seed=3, total_s=600.0)
    jrep, rep = online_both(trace, jfleet.host_pool(
        1, nic_mbps=NO_CONTENTION, slots=1), wave_s=5.0, dt=0.1,
        horizon_s=10.0)
    assert_online_same(jrep, rep)
    assert rep.dropped > 0
    assert rep.fold.transfers + rep.dropped <= len(trace)
    assert rep.sim_s == 10.0


# ---------------------------------------------------------- backpressure --

def test_backpressure_pauses_ingest_and_still_completes():
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ONE,
                                   controller="wget/curl", profile=CHAMELEON,
                                   name=f"b{i}", total_s=3600.0)
            for i in range(40)]
    jrep, rep = online_both(reqs, jfleet.host_pool(
        1, nic_mbps=NO_CONTENTION, slots=2), wave_s=5.0, dt=0.1,
        pool_capacity=2, queue_high=4, queue_low=1)
    assert_online_same(jrep, rep)
    assert rep.completed == 40
    assert rep.counters["ingest_paused_waves"] > 0
    assert rep.counters["peak_queue_depth"] <= 4


def test_on_wave_observability_callback():
    seen, jseen = [], []
    trace, hosts = _trace(n=6), jfleet.host_pool(2, **HOSTS)
    port_online(trace, hosts, wave_s=10.0, dt=0.5, on_wave=seen.append)
    jfleet.run_fleet_online(trace, hosts, wave_s=10.0, dt=0.5,
                            on_wave=jseen.append)
    assert seen == jseen and len(seen) >= 1
    for snap in seen:
        assert {"wave", "now", "queue_depth", "in_flight", "admitted",
                "retired", "ingest_paused", "recycled"} <= set(snap)
    assert sum(s["retired"] for s in seen) == 6


# ------------------------------------------------------------ validation --

@pytest.mark.parametrize("executor", ["blocked", "pallas"])
def test_jax_only_executor_names_raise(executor):
    """JAX's wave executors have no counterpart: the port's are ``auto``,
    ``reference`` (the plain wave loop, JAX's ``blocked``) and ``cuda``."""
    with pytest.raises(ValueError, match="unknown executor"):
        port_online(_trace(n=2), jfleet.host_pool(1, **HOSTS),
                    executor=executor)


def test_cuda_executor_on_the_cpu_raises():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        port_online(_trace(n=2), jfleet.host_pool(1, **HOSTS),
                    executor="cuda")


def test_reference_executor_equals_auto_on_the_cpu():
    trace, hosts = _trace(n=8), jfleet.host_pool(2, **HOSTS)
    a = port_online(trace, hosts, wave_s=10.0, dt=0.5, track_transfers=True)
    b = port_online(trace, hosts, wave_s=10.0, dt=0.5, track_transfers=True,
                    executor="reference")
    assert_online_equal(a, b)


def test_too_many_partitions_names_the_knob():
    wide = tuple(DatasetSpec(f"d{i}", 5, 100.0, 1.0) for i in range(4))
    req = jfleet.TransferRequest(arrival_s=0.0, datasets=wide,
                                 controller="wget/curl", profile=CHAMELEON,
                                 total_s=600.0)
    with pytest.raises(ValueError, match="max_partitions"):
        port_online([req], jfleet.host_pool(1, **HOSTS), max_partitions=2)


def test_config_validation():
    with pytest.raises(ValueError):
        tfleet.OnlineConfig(pool_capacity=0)
    with pytest.raises(ValueError):
        tfleet.OnlineConfig(queue_low=10, queue_high=5)
    with pytest.raises(ValueError):
        tfleet.OnlineConfig(max_partitions=0)
    with pytest.raises(ValueError, match="not both"):
        tfleet.OnlineConfig(devices=CPU, mesh=tshd.MeshConfig())
    with pytest.raises(ValueError, match="shorter than dt"):
        port_online(_trace(n=2), jfleet.host_pool(1, **HOSTS), wave_s=0.01,
                    dt=0.1)


def test_api_reexports_online_entry_points():
    assert tapi.run_fleet_online is tfleet.run_fleet_online
    assert tapi.OnlineConfig is tfleet.OnlineConfig
    assert tapi.OnlineFleetReport is tfleet.OnlineFleetReport
    assert tapi.poisson_stream is tfleet.poisson_stream
    assert tapi.diurnal_stream is tfleet.diurnal_stream
    assert tapi.replay_stream is tfleet.replay_stream


# -------------------------------------------------------------- streams --

def test_poisson_stream_is_lazy_deterministic_and_sorted():
    from torch_parity import port_datasets, port_profile
    kw = dict(rate_per_s=2.0, datasets=[port_datasets(ONE),
                                        port_datasets(FAST)],
              controllers=("eemt", "me"), profile=port_profile(CHAMELEON),
              seed=42, n_transfers=50)
    a = list(tfleet.poisson_stream(**kw))
    b = list(tfleet.poisson_stream(**kw))
    assert a == b and len(a) == 50
    arrivals = [r.arrival_s for r in a]
    assert arrivals == sorted(arrivals)
    it = tfleet.poisson_stream(**{**kw, "n_transfers": None})
    prefix = [next(it) for _ in range(10)]
    jit = jfleet.poisson_stream(rate_per_s=2.0, datasets=[ONE, FAST],
                                controllers=("eemt", "me"),
                                profile=CHAMELEON, seed=42,
                                n_transfers=None)
    assert prefix == [port_request(next(jit)) for _ in range(10)]


def test_diurnal_stream_rate_modulation_and_validation():
    from torch_parity import port_datasets, port_profile
    kw = dict(datasets=[port_datasets(ONE)], controllers=("wget/curl",),
              profile=port_profile(CHAMELEON))
    reqs = list(tfleet.diurnal_stream(base_rate_per_s=0.5,
                                      peak_rate_per_s=20.0, period_s=100.0,
                                      seed=1, n_transfers=400, **kw))
    arrivals = np.asarray([r.arrival_s for r in reqs])
    assert (np.diff(arrivals) >= 0.0).all()
    phase = np.mod(arrivals, 100.0)
    near_peak = ((phase > 25.0) & (phase < 75.0)).sum()
    assert near_peak > len(reqs) // 2
    with pytest.raises(ValueError):
        next(tfleet.diurnal_stream(base_rate_per_s=5.0, peak_rate_per_s=1.0,
                                   period_s=100.0, **kw))


def test_replay_stream_rejects_unsorted():
    r0, r1 = (port_request(jfleet.TransferRequest(
        arrival_s=t, datasets=ONE, controller="wget/curl", profile=CHAMELEON,
        name=n, total_s=600.0)) for t, n in ((5.0, "late"), (1.0, "early")))
    with pytest.raises(ValueError, match="arrival"):
        list(tfleet.replay_stream([r0, r1]))
    with pytest.raises(ValueError, match="arrival"):
        tfleet.run_fleet_online([r0, r1], [port_host(h) for h in
                                           jfleet.host_pool(1, **HOSTS)],
                                devices=CPU)


# ------------------------------------------- the card's route, rehearsed --

def _stand_in_card(monkeypatch):
    """Let ``"cuda"`` name a stand-in card: devices resolve without one,
    the rows stay on the CPU, and the tick kernel's wave mode
    (``engine.run_cuda_wave_groups``) runs the plain wave.  Returns the
    list of launches (the batches each took) and the list of plain wave
    runner calls."""
    from repro_torch.core import engine as tengine
    from repro_torch.fleet import online as tonline
    from repro_torch.fleet import scheduler as tsched
    from repro_torch.kernels import tick_loop as tl

    to_device, plain_runner = tsched._to_device, tengine.get_wave_runner
    launched, plain = [], []

    def on_cpu(dev, items):
        return to_device("cpu", items)

    def card(waves):
        launched.append(len(waves))
        return tl.tick_wave_grouped(waves)

    def runner(*a):
        plain.append(a)
        return plain_runner(*a)

    monkeypatch.setattr(tonline, "resolve_device", torch.device)
    monkeypatch.setattr(tsched, "_to_device", on_cpu)
    monkeypatch.setattr(tengine, "run_cuda_wave_groups", card)
    monkeypatch.setattr(tengine, "get_wave_runner", runner)
    return launched, plain


def test_card_route_is_one_launch_a_wave(monkeypatch):
    """On a card every occupied pool of a wave goes through the kernel's
    wave mode in ONE call (one launch), never the plain loop; the report
    equals the CPU's bit for bit.  Three controllers make three pools, and
    a 15-tick wave at controller stride 2 puts lanes admitted in different
    waves out of phase."""
    trace, hosts = _trace(n=24), jfleet.host_pool(2, **HOSTS)
    kw = dict(wave_s=7.5, dt=0.5, pool_capacity=8, track_transfers=True)
    cpu = port_online(trace, hosts, **kw)
    off = port_offline(trace, hosts, wave_s=7.5, dt=0.5)
    assert [transfer_fields(t) for t in cpu.transfers] == \
        [transfer_fields(t) for t in off.transfers]
    launched, plain = _stand_in_card(monkeypatch)
    card = port_online(trace, hosts, devices=("cuda",), **kw)
    assert_online_equal(cpu, card)
    assert len(launched) == card.waves and not plain
    assert max(launched) == card.counters["pools"] == 3


def test_too_many_partitions_for_the_kernel_raise_before_a_wave(
        monkeypatch):
    """``max_partitions`` above the kernel's 8 with the cuda executor
    (``auto`` on a card, or asked for) raises before the first wave and
    names the knob and the plain executor; nothing falls back to the plain
    loop.  The plain loop itself takes P 9, bit-equal to P 8."""
    trace, hosts = _trace(n=6), jfleet.host_pool(2, **HOSTS)
    kw = dict(wave_s=10.0, dt=0.5, track_transfers=True)
    p8 = port_online(trace, hosts, **kw)
    p9 = port_online(trace, hosts, max_partitions=9, executor="reference",
                     **kw)
    assert [transfer_fields(t) for t in p8.transfers] == \
        [transfer_fields(t) for t in p9.transfers]
    launched, plain = _stand_in_card(monkeypatch)
    for executor in ("auto", "cuda"):
        with pytest.raises(ValueError, match=r"max_partitions=9.*"
                                             r"executor=\"reference\""):
            port_online(trace, hosts, devices=("cuda",), max_partitions=9,
                        executor=executor, **kw)
    assert not launched and not plain


def test_devices_split_each_pool_and_change_nothing(monkeypatch):
    """Two devices (both the CPU): ``pool_capacity`` rounds up to a
    multiple of 2, each pool's rows split over them; per-transfer records
    and totals equal one device's.  A MeshConfig of two devices does the
    same."""
    trace, hosts = _trace(n=24), jfleet.host_pool(2, **HOSTS)
    kw = dict(wave_s=10.0, dt=0.5, pool_capacity=7, track_transfers=True)
    one = port_online(trace, hosts, **kw)
    two = port_online(trace, hosts, devices=("cpu", "cpu"), **kw)
    assert [transfer_fields(t) for t in one.transfers] == \
        [transfer_fields(t) for t in two.transfers]
    assert (one.total_energy_j, one.sim_s, one.waves) == \
        (two.total_energy_j, two.sim_s, two.waves)
    assert (one.counters["pool_capacity"], two.counters["pool_capacity"]) \
        == (7, 8)
    cpu2 = (torch.device("cpu"), torch.device("cpu"))
    monkeypatch.setattr(tshd, "local_devices", lambda: cpu2)
    mesh = port_online(trace, hosts, devices=None,
                       mesh=tshd.MeshConfig(num_hosts=1,
                                            devices_per_host=2), **kw)
    assert_online_equal(two, mesh)


# ------------------------------------------------------- bounded memory --

_SUBPROCESS_SCRIPT = r"""
import resource
import sys
sys.modules["jax"] = None       # the port alone
sys.modules["repro"] = None
from repro_torch import fleet
from repro_torch.core.types import CHAMELEON, DatasetSpec

ONE = (DatasetSpec("c", 50, 500.0, 10.0),)
HOSTS = fleet.host_pool(4, nic_mbps=CHAMELEON.bandwidth_mbps, slots=8)

def stream(n):
    return fleet.poisson_stream(rate_per_s=2.0, datasets=[ONE],
                                controllers=("eemt", "wget/curl"),
                                profile=CHAMELEON, seed=9, n_transfers=n,
                                total_s=1e9)

KW = dict(wave_s=10.0, dt=0.5, pool_capacity=16, devices=("cpu", "cpu"))

def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

small = fleet.run_fleet_online(stream(60), HOSTS, **KW)
rss_small = rss_mb()
big = fleet.run_fleet_online(stream(600), HOSTS, **KW)
rss_big = rss_mb()
assert (small.fold.transfers, big.fold.transfers) == (60, 600)
assert big.counters["peak_pool_in_flight"] <= 16
growth = rss_big - rss_small
assert growth < 128.0, (rss_small, rss_big)
print(f"ONLINE-RSS-FLAT-OK growth={growth:.1f}MB")
"""


def test_online_memory_does_not_grow_with_the_stream():
    """tests/test_fleet_online.py:337's bounded-memory case in a process
    of its own (``ru_maxrss`` is per process), on two devices: 60 against
    600 transfers through the same pools, peak RSS growth under 128 MB."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, \
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "ONLINE-RSS-FLAT-OK" in proc.stdout
