"""repro_torch.fleet.aggregates against math.fsum, numpy and the JAX
package's repro.fleet.aggregates, with seeded numpy inputs.

* ``ExactSum`` is held to ``math.fsum`` directly, in the given order and
  shuffled, over float32-width values in the range the reference's own
  property test asks for.  (That test, tests/test_ringbuf.py::
  test_exact_sum_is_order_independent_and_exact, fails before it draws an
  example: hypothesis refuses ``min_value=-1e12`` at ``width=32``, which
  float32 cannot represent.  Its subject is sound; ROADMAP queue 3.)
* ``QuantileSketch``: the cases of tests/test_ringbuf.py (:127-159) — its
  relative-error bound against the nearest-rank percentile, order
  invariance, the empty sketch, fixed memory — and equal counts and
  answers to JAX's sketch.
* ``FleetFold`` / ``OnlineFleetReport`` fed a fleet's transfers in any
  order: totals equal the ``FleetReport``'s bit for bit, percentiles
  within the sketch's ``rel_err`` of the nearest-rank ones, and every
  value equal to JAX's fold of the same records.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.fleet import aggregates as jagg
from repro_torch.fleet import aggregates as tagg
from repro_torch.fleet.aggregates import (ExactSum, FleetFold,
                                          OnlineFleetReport, QuantileSketch)

F32_MAX_E12 = 999999995904.0     # float32's nearest to 1e12, from below


def _lists(seed, n_lists):
    """Seeded value lists: uniform, wide exponents, exact cancellations,
    and a menu of awkward values (signed zeros, subnormal float32)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_lists):
        n = int(rng.integers(0, 200))
        kind = k % 4
        if kind == 0:
            v = rng.uniform(-F32_MAX_E12, F32_MAX_E12, n)
        elif kind == 1:
            v = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 12, n)
        elif kind == 2:
            v = rng.uniform(-F32_MAX_E12, F32_MAX_E12, n // 2)
            v = np.concatenate([v, -v])
        else:
            v = rng.choice([F32_MAX_E12, -F32_MAX_E12, 1.0, -1.0, 1e-30,
                            3.0, 0.5, -0.0, 0.0, 2.0 ** -60, 1e-45], n)
        out.append([float(np.float32(x)) for x in v])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_exact_sum_is_fsum_in_any_order(seed):
    rng = np.random.default_rng(100 + seed)
    for values in _lists(seed, 250):
        want = math.fsum(values)
        for order in (values, list(rng.permutation(values))):
            acc, jacc = ExactSum(), jagg.ExactSum()
            for v in order:
                acc.add(v)
                jacc.add(v)
            got = acc.value()
            assert got == want and math.copysign(1, got) == \
                math.copysign(1, want), values
            assert jacc.value() == got
    assert ExactSum().value() == 0.0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_quantile_sketch_relative_error_bound(seed, q):
    """Sketch quantile within rel_err of the nearest-rank reference, and
    equal to JAX's sketch of the same values."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    values = 10.0 ** rng.uniform(-3, 7, n)
    sk, jsk = QuantileSketch(rel_err=0.01), jagg.QuantileSketch(rel_err=0.01)
    for v in values:
        sk.add(v)
        jsk.add(v)
    got = sk.quantile(q)
    ref = float(np.percentile(values, 100 * q, method="inverted_cdf"))
    assert abs(got - ref) <= 0.0101 * ref + 1e-12
    assert got == jsk.quantile(q)
    assert np.array_equal(sk.counts, jsk.counts)


def test_quantile_sketch_order_invariant_and_empty():
    sk = QuantileSketch()
    assert sk.quantile(0.5) is None
    assert sk.percentiles() == {"p50": None, "p95": None, "p99": None}
    vals = np.random.default_rng(0).uniform(0.1, 1e4, 500)
    a, b = QuantileSketch(), QuantileSketch()
    for v in vals:
        a.add(v)
    for v in vals[::-1]:
        b.add(v)
    assert a.percentiles() == b.percentiles()
    assert np.array_equal(a.counts, b.counts)
    for v in (0.0, -1.0, 1e-9, 1e12):      # zero bucket and clamps
        a.add(v)
    with pytest.raises(ValueError):
        QuantileSketch(rel_err=1.5)
    with pytest.raises(ValueError):
        QuantileSketch(lo=2.0, hi=1.0)


def test_quantile_sketch_memory_is_fixed():
    sk = QuantileSketch()
    n0 = len(sk.counts)
    for i in range(10_000):
        sk.add(0.01 * (i + 1))
    assert len(sk.counts) == n0 == len(jagg.QuantileSketch().counts)
    assert sk.n == 10_000


def _transfers(seed, n):
    """Seeded FleetTransfer records of both packages (same values)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        arrival = float(rng.uniform(0, 1000))
        kw = dict(name=f"x{i:03d}",
                  controller=str(rng.choice(["EEMT", "ME", "wget/curl"])),
                  host=f"host-{int(rng.integers(0, 4))}",
                  arrival_s=arrival,
                  start_s=arrival + float(rng.choice([0.0, 15.0, 30.0])),
                  time_s=float(np.float32(rng.uniform(1, 300))),
                  energy_j=float(np.float32(rng.uniform(10, 1e4))),
                  moved_mb=float(np.float32(rng.uniform(100, 2e4))),
                  completed=bool(rng.random() < 0.9),
                  ideal_s=float(rng.uniform(0.5, 100)))
        out.append((tagg.FleetTransfer(**kw), jagg.FleetTransfer(**kw)))
    return out


@pytest.mark.parametrize("slo_s", [None, 120.0])
def test_fleet_fold_matches_offline_report_and_jax(slo_s):
    pairs = _transfers(3, 400)
    ts = tuple(t for t, _ in pairs)
    report = tagg.FleetReport(transfers=ts, host_stats=(), sim_s=1e3,
                              waves=10, wave_s=15.0, dt=0.5, slo_s=slo_s)
    jreport = jagg.FleetReport(transfers=tuple(j for _, j in pairs),
                               host_stats=(), sim_s=1e3, waves=10,
                               wave_s=15.0, dt=0.5, slo_s=slo_s)
    assert report.summary() == jreport.summary()
    order = np.random.default_rng(4).permutation(len(pairs))
    fold, jfold = FleetFold(slo_s=slo_s), jagg.FleetFold(slo_s=slo_s)
    for k in order:
        fold.add(pairs[k][0])
        jfold.add(pairs[k][1])
    assert fold.total_energy_j == report.total_energy_j
    assert fold.total_gb == report.total_gb
    assert fold.completed == report.completed
    assert fold.by_controller() == jfold.by_controller()
    for name, row in report.by_controller().items():
        frow = fold.by_controller()[name]
        for k in ("transfers", "completed", "energy_j", "gb",
                  "joules_per_gb", "mean_time_s", "mean_wait_s"):
            assert frow[k] == row[k], (name, k)
        slow = [t.slowdown for t in ts
                if t.controller == name and t.completed]
        for p, q in (("p50", 50), ("p95", 95), ("p99", 99)):
            v = float(np.percentile(slow, q, method="inverted_cdf"))
            assert abs(frow["slowdown"][p] - v) <= 0.0101 * v
    if slo_s is not None:
        assert fold.slo_violations() == report.slo_violations()
        assert fold.latencies() == jfold.latencies()
    else:
        with pytest.raises(ValueError):
            fold.slo_violations()
    online = OnlineFleetReport(fold=fold, host_stats=(), sim_s=1e3,
                               waves=10, wave_s=15.0, dt=0.5,
                               counters={"waves": 10})
    jonline = jagg.OnlineFleetReport(fold=jfold, host_stats=(), sim_s=1e3,
                                     waves=10, wave_s=15.0, dt=0.5,
                                     counters={"waves": 10})
    assert online.summary() == jonline.summary()
    assert set(online.summary()) == set(report.summary()) | {"counters"}
    assert online.to_json() == jonline.to_json()


def test_transfer_record_views_equal_jax():
    for t, j in _transfers(5, 50):
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert (t.wait_s, t.response_s, t.slowdown) == \
            (j.wait_s, j.response_s, j.slowdown)
