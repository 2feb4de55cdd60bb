"""repro_torch.workloads (faults, HTTP services) against the JAX package's
repro.workloads, through both of the port's fleet drivers, on the CPU.

Every case of tests/test_workloads.py:59-331 has a counterpart here:

* ``FaultSchedule.generate`` and the HTTP request streams equal JAX's for
  the same seeds, event for event and request for request;
* the empty schedule is a bit-exact no-op, the summary only gains keys;
* under ``restart="resume"`` a fully completed run has ``goodput_mb ==
  offered_mb`` bit-exactly in both drivers and wastes nothing;
  ``"scratch"`` wastes the killed attempts' bytes;
* the port's offline and online drivers give identical per-transfer
  records and churn ledgers (bit for bit), and both equal JAX's reports
  and ledgers: placement, start, completion, time, kill and restart
  counts exact, energy and MB to ``JIT_RTOL`` (JAX runs jitted waves).

The offline fault hook (``run_fleet(faults=..., slo_s=...)``) is held
against JAX's here first: every other case builds on it.
"""
import dataclasses
import math

import pytest

from repro import fleet as jfleet
from repro import workloads as jwl
from repro.core.types import CHAMELEON, DatasetSpec
from repro_torch import fleet as tfleet
from repro_torch import workloads as twl
from test_torch_fleet import (assert_same, close, port_host, port_request,
                              transfer_fields)
from torch_parity import port_datasets, port_profile

# Transfers sized to span several 10 s waves (30 000 MB at <= 1250 MB/s),
# so outages and kills reliably catch lanes in flight.
BULK = (DatasetSpec("bulk", 1_000, 30_000.0, 30.0),)
CPU = ("cpu",)
CHURN_EXACT = ("restart", "kills", "host_loss_kills", "transfer_kills",
               "restarts", "retired", "completed")


def _trace(n=12, seed=1810):
    return jfleet.poisson_trace(rate_per_s=0.05, n_transfers=n,
                                datasets=[BULK], controllers=("eemt", "me"),
                                profile=CHAMELEON, seed=seed,
                                total_s=3600.0)


def _hosts(n=2):
    return jfleet.host_pool(n, nic_mbps=2.0 * CHAMELEON.bandwidth_mbps,
                            slots=4)


# xfer-00 is admitted to a host at t=30 and runs ~30 s: an outage opening
# at 45 catches it mid-flight, and the named kill catches a later lane.
FAULTS = (jwl.HostDown(0, 45.0, 90.0), jwl.KillTransfer("xfer-02", 100.0))


def port_event(e):
    return getattr(twl, type(e).__name__)(*dataclasses.astuple(e))


def port_faults(fs):
    return twl.FaultSchedule(events=tuple(port_event(e) for e in fs.events),
                             restart=fs.restart)


def offline(trace, hosts, faults=None, **kw):
    """The port's ``run_fleet`` of a JAX trace and pool (and schedule)."""
    return tfleet.run_fleet([port_request(r) for r in trace],
                            [port_host(h) for h in hosts], devices=["cpu"],
                            faults=faults and port_faults(faults), **kw)


def online(stream, hosts, faults=None, **kw):
    return tfleet.run_fleet_online(
        [port_request(r) for r in stream], [port_host(h) for h in hosts],
        devices=CPU, faults=faults and port_faults(faults), **kw)


def assert_churn_same(trep, jrep):
    """A port churn ledger against JAX's: counts exact, MB and J to
    ``JIT_RTOL``."""
    t, j = trep.churn, jrep.churn
    assert set(t) == set(j)
    assert {k: t[k] for k in CHURN_EXACT} == {k: j[k] for k in CHURN_EXACT}
    for k in set(t) - set(CHURN_EXACT):
        assert close(t[k], j[k]) or t[k] == j[k] == 0.0, (k, t[k], j[k])


def fields(rep):
    return [transfer_fields(t) for t in rep.transfers]


# ------------------------------------------------- schedules and streams --

@pytest.mark.parametrize("restart", ["resume", "scratch"])
def test_generated_schedule_equals_jax(restart):
    kw = dict(n_hosts=3, horizon_s=4000.0, seed=5, host_loss_per_hour=6.0,
              outage_s=80.0, nic_degrade_per_hour=9.0, degrade_s=200.0,
              degrade_factor=0.3, restart=restart)
    j = jwl.FaultSchedule.generate(**kw)
    t = twl.FaultSchedule.generate(**kw)
    assert len(t.events) > 4
    assert t == port_faults(j)
    assert t == twl.FaultSchedule.generate(**kw)
    assert twl.FaultSchedule.generate(n_hosts=2, horizon_s=10.0).events == ()
    for bad in (dict(n_hosts=0, horizon_s=1.0), dict(n_hosts=1,
                                                     horizon_s=0.0)):
        with pytest.raises(ValueError):
            twl.FaultSchedule.generate(**bad)


def test_schedule_driver_hooks_equal_jax():
    fs = jwl.FaultSchedule(events=(
        jwl.HostDown(1, 10.0, 50.0), jwl.NicDegrade(0, 0.0, 30.0, 0.5),
        jwl.NicDegrade(0, 20.0, 40.0, 0.25), jwl.NicDegrade(7, 0.0, 9.0),
        jwl.KillTransfer("a", 10.0), jwl.KillTransfer("b", 25.0)))
    ts = port_faults(fs)
    hosts = _hosts(2)
    for t0 in (-math.inf, 0.0, 10.0, 20.0, 40.0, 60.0):
        t1 = t0 + 10.0 if math.isfinite(t0) else 5.0
        assert ts.down_hosts(t0, t1) == fs.down_hosts(t0, t1)
        assert ts.nic_caps(hosts, t0, t1) == fs.nic_caps(hosts, t0, t1)
        assert ts.kills_in(t0, t1) == fs.kills_in(t0, t1)


SVC = dict(request_mb=64.0, size_menu=(0.5, 1.0, 2.0), conn_setup_mb=16.0,
           think_s=4.0, n_users=4, seed=7)


def http_services(**kw):
    """(JAX's HttpService, the port's) of one spec."""
    kw = {**SVC, **kw}
    tkw = dict(kw, profile=port_profile(kw.get("profile", CHAMELEON)))
    return jwl.HttpService(**kw), twl.HttpService(**tkw)


@pytest.mark.parametrize("keepalive_s", [0.0, 30.0, math.inf])
def test_http_stream_equals_jax(keepalive_s):
    jsvc, tsvc = http_services(keepalive_s=keepalive_s,
                               controllers=("eemt", "wget/curl"))
    j = jwl.http_request_trace(jsvc, n_requests=50)
    t = twl.http_request_trace(tsvc, n_requests=50)
    assert t == tuple(port_request(r) for r in j)
    it = twl.http_request_stream(tsvc, name_prefix="svc")
    jit = jwl.http_request_stream(jsvc, name_prefix="svc")
    assert [next(it) for _ in range(60)] == \
        [port_request(next(jit)) for _ in range(60)]


def test_http_stream_deterministic_and_ordered():
    _, svc = http_services()
    a = twl.http_request_trace(svc, n_requests=40)
    b = twl.http_request_trace(svc, n_requests=40)
    assert a == b
    arr = [r.arrival_s for r in a]
    assert arr == sorted(arr)
    assert len({r.name for r in a}) == 40
    _, svc8 = http_services(seed=8)
    assert twl.http_request_trace(svc8, n_requests=40) != a
    with pytest.raises(ValueError):
        twl.http_request_trace(svc, n_requests=0)


def test_http_cold_warm_connection_logic():
    _, svc = http_services(keepalive_s=0.0)
    cold = twl.http_request_trace(svc, n_requests=30)
    assert all(len(r.datasets) == 2 for r in cold)
    assert all(r.datasets[0].name == "conn-setup" for r in cold)
    _, svc = http_services(keepalive_s=math.inf)
    warm = twl.http_request_trace(svc, n_requests=30)
    assert sum(len(r.datasets) == 2 for r in warm) == SVC["n_users"]
    assert cold[0].datasets[0].total_mb == SVC["conn_setup_mb"]


def test_http_service_validation():
    for bad in (dict(request_mb=0.0), dict(size_menu=()),
                dict(think_s=0.0), dict(n_users=0), dict(controllers=()),
                dict(conn_setup_mb=-1.0), dict(keepalive_s=-1.0)):
        with pytest.raises(ValueError):
            twl.HttpService(**{**SVC, **bad})
    with pytest.raises(ValueError):
        twl.ServiceLevel(0.0)
    with pytest.raises(ValueError):
        twl.ServiceLevel(1.0, max_violation_rate=1.5)


# ------------------------------------------------------ fault-free no-op --

def test_empty_schedule_is_bitexact_noop():
    trace, hosts = _trace(), _hosts()
    plain = offline(trace, hosts, wave_s=10.0, dt=0.5)
    faulted = offline(trace, hosts, wave_s=10.0, dt=0.5,
                      faults=jwl.FaultSchedule())
    assert faulted.transfers == plain.transfers   # frozen rows: bit-exact
    assert faulted.host_stats == plain.host_stats
    c = faulted.churn
    assert c["kills"] == c["restarts"] == 0
    assert c["goodput_mb"] == c["offered_mb"]
    assert c["wasted_mb"] == 0.0
    jrep = jfleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5,
                            faults=jwl.FaultSchedule())
    assert_same(jrep, faulted)
    assert_churn_same(faulted, jrep)


def test_summary_only_gains_keys():
    trace, hosts = _trace(6), _hosts()
    plain = offline(trace, hosts, wave_s=10.0, dt=0.5)
    s0 = plain.summary()
    assert "latency" not in s0 and "slo" not in s0 and "churn" not in s0
    armed = offline(trace, hosts, wave_s=10.0, dt=0.5,
                    faults=jwl.FaultSchedule(), slo_s=300.0)
    s1 = armed.summary()
    assert set(s0) < set(s1)
    assert {k: s1[k] for k in s0} == s0
    assert s1["slo"]["slo_s"] == 300.0
    jarmed = jfleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5,
                              faults=jwl.FaultSchedule(), slo_s=300.0)
    assert set(s1) == set(jarmed.summary())
    assert s1["slo"] == jarmed.summary()["slo"]
    with pytest.raises(ValueError, match="no SLO"):
        plain.slo_violations()


# --------------------------------------------- determinism & driver parity --

def test_offline_fault_hook_matches_jax():
    """The offline driver's fault hook against JAX's: host loss, a named
    kill and an SLO, every transfer and the churn ledger."""
    trace, hosts = _trace(), _hosts()
    fs = jwl.FaultSchedule(events=FAULTS)
    jrep = jfleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5, faults=fs,
                            slo_s=200.0)
    rep = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs, slo_s=200.0)
    assert rep.churn["kills"] >= 2
    assert_same(jrep, rep)
    assert_churn_same(rep, jrep)
    assert rep.slo_violations() == jrep.slo_violations()
    again = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs,
                    slo_s=200.0)
    assert again.transfers == rep.transfers and again.churn == rep.churn


def test_offline_online_fault_parity():
    """Same schedule, both of the port's drivers: per-transfer records and
    the churn ledger bit-identical; the online report equals JAX's."""
    trace, hosts = _trace(), _hosts()
    fs = jwl.FaultSchedule(events=FAULTS)
    srt = sorted(trace, key=lambda r: r.arrival_s)
    off = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs, slo_s=200.0)
    on = online(srt, hosts, wave_s=10.0, dt=0.5, faults=fs, slo_s=200.0,
                pool_capacity=64, track_transfers=True)
    assert off.churn["kills"] >= 2          # the schedule actually bit
    assert tuple(on.transfers) == tuple(
        sorted(off.transfers, key=lambda t: (t.start_s, t.name)))
    assert on.churn == off.churn
    assert on.slo_violations() == off.slo_violations()
    jon = jfleet.run_fleet_online(srt, hosts, wave_s=10.0, dt=0.5,
                                  faults=fs, slo_s=200.0, pool_capacity=64,
                                  track_transfers=True)
    assert_churn_same(on, jon)
    assert [(t.name, t.host, t.start_s, t.time_s, t.completed)
            for t in on.transfers] == \
        [(t.name, t.host, t.start_s, t.time_s, t.completed)
         for t in jon.transfers]
    assert on.counters == jon.counters


# --------------------------------------------------------- conservation --

@pytest.mark.parametrize("driver", ["offline", "online"])
def test_resume_conserves_bytes_bitexactly(driver):
    trace, hosts = _trace(), _hosts()
    fs = jwl.FaultSchedule(events=FAULTS, restart="resume")
    if driver == "offline":
        rep = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs)
    else:
        rep = online(sorted(trace, key=lambda r: r.arrival_s), hosts,
                     wave_s=10.0, dt=0.5, faults=fs, pool_capacity=64)
    c = rep.churn
    assert c["kills"] >= 2 and c["restarts"] >= 2
    assert rep.completed == len(trace)
    assert c["goodput_mb"] == c["offered_mb"]     # bit-exact, not approx
    assert c["wasted_mb"] == 0.0
    assert c["throughput_mb"] == c["goodput_mb"]
    assert c["goodput_frac"] == 1.0


def test_scratch_wastes_killed_bytes():
    trace, hosts = _trace(), _hosts()
    fs = jwl.FaultSchedule(events=FAULTS, restart="scratch")
    rep = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs)
    c = rep.churn
    assert rep.completed == len(trace)
    assert c["wasted_mb"] > 0.0
    assert c["goodput_mb"] == c["offered_mb"]     # completed work intact
    assert c["goodput_frac"] < 1.0
    assert c["throughput_mb"] == pytest.approx(
        c["goodput_mb"] + c["wasted_mb"], abs=1e-6)
    assert_churn_same(rep, jfleet.run_fleet(trace, hosts, wave_s=10.0,
                                            dt=0.5, faults=fs))


def test_generated_schedule_conserves_bytes():
    trace, hosts = _trace(), _hosts()
    fs = jwl.FaultSchedule.generate(n_hosts=2, horizon_s=400.0, seed=3,
                                    host_loss_per_hour=40.0, outage_s=50.0,
                                    nic_degrade_per_hour=20.0, degrade_s=60.0)
    off = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs)
    on = online(sorted(trace, key=lambda r: r.arrival_s), hosts,
                wave_s=10.0, dt=0.5, faults=fs, pool_capacity=64)
    assert off.churn == on.churn
    assert off.churn["goodput_mb"] == off.churn["offered_mb"]
    jrep = jfleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5, faults=fs)
    assert_same(jrep, off)
    assert_churn_same(off, jrep)


# ------------------------------------------------------- fault semantics --

def test_host_down_blocks_admission():
    req = jfleet.TransferRequest(arrival_s=5.0, datasets=BULK,
                                 controller="eemt", profile=CHAMELEON,
                                 host=0, name="pinned", total_s=3600.0)
    fs = jwl.FaultSchedule(events=(jwl.HostDown(0, 0.0, 60.0),))
    hosts = jfleet.host_pool(1, slots=4)
    rep = offline([req], hosts, wave_s=10.0, dt=0.5, faults=fs)
    (t,) = rep.transfers
    assert t.completed
    assert t.start_s >= 60.0
    on = online([req], hosts, wave_s=10.0, dt=0.5, faults=fs,
                track_transfers=True)
    assert on.transfers == rep.transfers
    assert_same(jfleet.run_fleet([req], hosts, wave_s=10.0, dt=0.5,
                                 faults=fs), rep)


def test_nic_degrade_slows_but_kills_nothing():
    reqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=BULK,
                                   controller="eemt", profile=CHAMELEON,
                                   host=0, name=f"x{i}", total_s=3600.0)
            for i in range(2)]
    hosts = jfleet.host_pool(1, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    plain = offline(reqs, hosts, wave_s=10.0, dt=0.5)
    fs = jwl.FaultSchedule(events=(jwl.NicDegrade(0, 0.0, 600.0,
                                                  factor=0.25),))
    slow = offline(reqs, hosts, wave_s=10.0, dt=0.5, faults=fs)
    assert slow.churn["kills"] == 0
    assert slow.completed == 2
    assert min(t.time_s for t in slow.transfers) > \
        max(t.time_s for t in plain.transfers)
    assert_same(jfleet.run_fleet(reqs, hosts, wave_s=10.0, dt=0.5,
                                 faults=fs), slow)


def test_kill_of_unknown_transfer_is_noop():
    trace, hosts = _trace(6), _hosts()
    fs = jwl.FaultSchedule(events=(jwl.KillTransfer("no-such-transfer",
                                                    50.0),))
    plain = offline(trace, hosts, wave_s=10.0, dt=0.5)
    faulted = offline(trace, hosts, wave_s=10.0, dt=0.5, faults=fs)
    assert faulted.transfers == plain.transfers
    assert faulted.churn["kills"] == 0


def test_event_validation():
    with pytest.raises(ValueError):
        twl.HostDown(0, 10.0, 10.0)
    with pytest.raises(ValueError):
        twl.HostDown(-1, 0.0, 10.0)
    with pytest.raises(ValueError):
        twl.NicDegrade(0, 0.0, 10.0, factor=0.0)
    with pytest.raises(ValueError):
        twl.KillTransfer("", 1.0)
    with pytest.raises(ValueError, match="restart"):
        twl.FaultSchedule(restart="retry")
    with pytest.raises(TypeError):
        twl.FaultSchedule(events=("not-an-event",))
    with pytest.raises(ValueError, match="restart"):
        twl.ChurnFold(restart="retry")


# ------------------------------------------------------- arrivals edges --

def test_zero_rate_poisson_stream_is_empty():
    kw = dict(datasets=[port_datasets(BULK)], controllers=("eemt",),
              profile=port_profile(CHAMELEON))
    assert list(tfleet.poisson_stream(rate_per_s=0.0, **kw)) == []
    with pytest.raises(ValueError):
        list(tfleet.poisson_stream(rate_per_s=-1.0, **kw))


def test_diurnal_stream_flat_and_zero_base_endpoints():
    kw = dict(period_s=600.0, datasets=[BULK], controllers=("eemt",),
              n_transfers=20, seed=4)
    tkw = dict(kw, datasets=[port_datasets(BULK)],
               profile=port_profile(CHAMELEON))
    for base in (2.0, 0.0):
        t = list(tfleet.diurnal_stream(base_rate_per_s=base,
                                       peak_rate_per_s=2.0, **tkw))
        j = list(jfleet.diurnal_stream(base_rate_per_s=base,
                                       peak_rate_per_s=2.0,
                                       profile=CHAMELEON, **kw))
        assert len(t) == 20 and t == [port_request(r) for r in j]
    with pytest.raises(ValueError):
        list(tfleet.diurnal_stream(base_rate_per_s=3.0, peak_rate_per_s=2.0,
                                   **tkw))
    with pytest.raises(ValueError):
        list(tfleet.diurnal_stream(base_rate_per_s=0.0, peak_rate_per_s=0.0,
                                   **tkw))


def test_replay_stream_accepts_duplicate_timestamps():
    reqs = [port_request(jfleet.TransferRequest(
        arrival_s=5.0, datasets=BULK, controller="eemt", profile=CHAMELEON,
        name=f"dup-{i}")) for i in range(3)]
    assert list(tfleet.replay_stream(reqs)) == reqs
    bad = reqs + [dataclasses.replace(reqs[0], arrival_s=1.0, name=None)]
    with pytest.raises(ValueError, match="arrival order"):
        list(tfleet.replay_stream(bad))


# ------------------------------------------------------------------ HTTP --

def test_http_slo_metrics_offline_online():
    jsvc, _ = http_services()
    trace = jwl.http_request_trace(jsvc, n_requests=60)
    hosts = jfleet.host_pool(2, nic_mbps=4.0 * CHAMELEON.bandwidth_mbps)
    off = offline(trace, hosts, wave_s=5.0, dt=0.25, slo_s=6.0)
    on = online(trace, hosts, wave_s=5.0, dt=0.25, slo_s=6.0,
                pool_capacity=128, track_transfers=True)
    assert off.completed == on.completed == 60
    assert on.slo_violations() == off.slo_violations()
    assert fields(on) == fields(off)
    ref, got = off.latencies(), on.latencies()
    for p in ("p50", "p95", "p99"):
        assert abs(got[p] - ref[p]) <= 0.0101 * ref[p] + 1e-12
    ev = twl.ServiceLevel(6.0, max_violation_rate=1.0).evaluate(off)
    assert ev["met"] and ev["violations"] == off.slo_violations()
    jrep = jfleet.run_fleet(trace, hosts, wave_s=5.0, dt=0.25, slo_s=6.0)
    assert_same(jrep, off)
    assert off.slo_violations() == jrep.slo_violations()
    assert ev == jwl.ServiceLevel(6.0, max_violation_rate=1.0).evaluate(jrep)
