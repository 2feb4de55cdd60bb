"""The port's Report (``repro_torch.api.report``, host numpy) against the JAX
package's, on the same seeded rows: construction with derived metrics,
``select``, ``group_by``, ``vs_baseline``, ``argbest`` and the JSON payload
equal (``==`` on the floats and on the text), and each package reading the
other's JSON.  Both packages compute in float64 numpy, so no tolerance is
needed."""
import numpy as np
import pytest

from repro import api as japi
from repro_torch import api as tapi

SEEDS = range(4)


def _columns(seed):
    """A testbed x dataset x tool grid of seeded metrics, with one NaN."""
    rng = np.random.default_rng(seed)
    tbs, dss, tools = ("chameleon", "cloudlab"), ("small", "mixed"), (
        "learned", "ME", "EEMT", "wget/curl")
    rows = [(tb, ds, t) for tb in tbs for ds in dss for t in tools]
    n = len(rows)
    cols = {"testbed": [r[0] for r in rows], "dataset": [r[1] for r in rows],
            "tool": [r[2] for r in rows],
            "completed": rng.integers(0, 2, n).astype(float).tolist(),
            "time_s": rng.uniform(1, 900, n).tolist(),
            "energy_j": rng.uniform(10, 5e4, n).tolist(),
            "avg_tput_MBps": rng.uniform(10, 1300, n).tolist(),
            "avg_tput_gbps": rng.uniform(0.1, 10, n).tolist(),
            "avg_power_w": rng.uniform(5, 60, n).tolist()}
    cols["avg_power_w"][seed] = None
    return cols


AXES = ("testbed", "dataset", "tool")


def _row(row):
    """A row dict with NaN spelled as None (NaN != NaN)."""
    return {k: (None if v != v else v) for k, v in row.items()}


def _pair(seed, derive=True):
    cols = _columns(seed)
    return (japi.Report(cols, axes=AXES, meta={"seed": seed}, derive=derive),
            tapi.Report(cols, axes=AXES, meta={"seed": seed}, derive=derive))


def _same(a, b):
    assert a.axes == b.axes and a.columns == b.columns and a.meta == b.meta
    assert a.to_json() == b.to_json()
    for name in a.columns:
        if name in a.axes:
            assert list(a[name]) == list(b[name]), name
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_construction_and_derived_metrics_equal_jax(seed):
    for derive in (True, False):
        _same(*_pair(seed, derive))
    assert tapi.report.RESULT_METRICS == japi.report.RESULT_METRICS
    assert tapi.report.derive_row({"time_s": 2.0, "energy_j": 3.0,
                                   "avg_tput_MBps": 5.0}) == \
        japi.report.derive_row({"time_s": 2.0, "energy_j": 3.0,
                                "avg_tput_MBps": 5.0})


@pytest.mark.parametrize("seed", SEEDS)
def test_views_equal_jax(seed):
    j, t = _pair(seed)
    _same(j.select(testbed="cloudlab"), t.select(testbed="cloudlab"))
    _same(j.select(energy_j=lambda e: e > 2e4),
          t.select(energy_j=lambda e: e > 2e4))
    for agg in ("mean", "sum", "min", "max"):
        _same(j.group_by("tool", agg=agg), t.group_by("tool", agg=agg))
    _same(j.group_by("testbed", "dataset", metrics=("energy_j",)),
          t.group_by("testbed", "dataset", metrics=("energy_j",)))
    _same(j.vs_baseline("tool", "EEMT"), t.vs_baseline("tool", "EEMT"))
    _same(j.vs_baseline("dataset", "small", metrics=("time_s",)),
          t.vs_baseline("dataset", "small", metrics=("time_s",)))
    for mode in ("min", "max"):
        assert _row(j.argbest("edp", mode=mode)) == \
            _row(t.argbest("edp", mode=mode))
    where = lambda row: row["avg_tput_gbps"] >= 5.0  # noqa: E731
    assert _row(j.argbest("energy_j", where=where)) == \
        _row(t.argbest("energy_j", where=where))
    with pytest.raises(ValueError):
        t.argbest("energy_j", where=lambda row: False)
    assert j.table() == t.table()


@pytest.mark.parametrize("seed", SEEDS)
def test_json_round_trips_between_the_packages(seed, tmp_path):
    j, t = _pair(seed)
    path = str(tmp_path / "t.json")
    t.to_json(path)
    _same(japi.Report.from_json(path), t)
    _same(tapi.Report.from_json(j.to_json()), j)
    _same(tapi.Report.from_json(t.to_json()), t)
    rows = t.rows()
    _same(tapi.Report.from_rows(iter(rows), axes=AXES, derive=False),
          japi.Report.from_rows(iter(rows), axes=AXES, derive=False))
    assert np.isnan(tapi.Report.from_json(t.to_json())["avg_power_w"][seed])
    with pytest.raises(ValueError):
        tapi.Report.from_dict({"schema": "something/else", "axes": [],
                               "columns": {}})
