"""The port's Experiment surface (``repro_torch.api.experiments``) against
the JAX package's: space composition, cells, labels, names and content
keys (``scenario_key`` equal to JAX's, spelling for spelling), the figure
Experiments that ``chip_smoke.py`` runs (its copies of
``benchmarks/fig2.py`` and ``benchmarks/fig_dvfs.py``) cell for cell, the
per-cell cache (hits, partial resume, version mismatch, clear), and a small
grid's Report against JAX's: discrete fields exact, floats to rtol 1e-6
(the port follows JAX's op-by-op float32 semantics; jitted XLA fuses some
ops, ROADMAP queue 3)."""
import json
import os
import sys

import numpy as np
import pytest

from repro import api as japi
from repro.core import types as jtypes
from repro_torch import api as tapi
from repro_torch.core import types as ttypes

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the figure Experiments it runs)
from benchmarks import fig2, fig_dvfs  # noqa: E402

FAST = (("a", 200, 400.0, 2.0), ("b", 10, 600.0, 60.0))
TOTAL_S = 120.0


def small_experiment(api, types, tools=("wget/curl", "http/2")):
    """tests/test_experiments.py's small grid, in either package."""
    return api.Experiment(
        name="t",
        space=api.grid(
            api.axis("testbed", {"chameleon": types.CHAMELEON,
                                 "cloudlab": types.CLOUDLAB},
                     field="profile"),
            api.axis("tool", tools)),
        base={"datasets": tuple(types.DatasetSpec(*d) for d in FAST),
              "cpu": types.CpuProfile(), "total_s": TOTAL_S,
              "controller": lambda c: c["tool"]})


def _cells(exp):
    return [(c.labels, c.scenario.name, c.key) for c in exp.cells()]


def test_spaces_compose_as_in_jax():
    for api in (japi, tapi):
        a = api.axis("x", {"lo": 1, "hi": 2})
        assert a.labels == ("lo", "hi") and a.values == (1, 2)
        assert api.axis("x", [1, 2.5, "s"]).labels == ("1", "2.5", "s")
        with pytest.raises(ValueError):
            api.axis("x", [])
        with pytest.raises(ValueError):
            api.axis("x", [1], field="not-a-scenario-field")
    j = japi.grid(japi.axis("t", ["x", "y"]), japi.chain(
        japi.grid(a=[1, 2], s=[True, False]), japi.axis("a", [9])))
    t = tapi.grid(tapi.axis("t", ["x", "y"]), tapi.chain(
        tapi.grid(a=[1, 2], s=[True, False]), tapi.axis("a", [9])))
    assert t.axis_names() == j.axis_names() == ("t", "a", "s")
    assert t.cells() == j.cells()
    z = tapi.zip_(tapi.axis("a", [1, 2]), tapi.axis("b", [3, 4]))
    assert z.cells() == japi.zip_(japi.axis("a", [1, 2]),
                                  japi.axis("b", [3, 4])).cells()
    with pytest.raises(ValueError):
        tapi.zip_(tapi.axis("a", [1, 2]), tapi.axis("b", [3])).cells()


def test_cells_labels_names_and_keys_equal_jax():
    assert _cells(small_experiment(tapi, ttypes)) == \
        _cells(small_experiment(japi, jtypes))
    exp = small_experiment(tapi, ttypes)
    cell = exp.cell_for({"testbed": ttypes.CHAMELEON, "tool": "wget/curl"})
    assert cell.labels == {"testbed": "chameleon", "tool": "wget/curl"}
    assert cell.key == next(c for c in exp.cells()
                            if c.labels == cell.labels).key
    with pytest.raises(ValueError):
        tapi.Experiment(name="t", space=tapi.axis("tool", ["ME"]),
                        base={"not_a_field": 1})


@pytest.mark.parametrize("name", ["fig2-smoke", "fig2", "fig_dvfs",
                                  "greendataflow"])
def test_figure_experiments_equal_the_benchmarks(name):
    """chip_smoke.py's figure Experiments are benchmarks/'s, cell for cell:
    labels, scenario names and content keys (so every canonical field of
    every scenario, the dvfs environments included, hashes as in JAX)."""
    port, ref = {
        "fig2-smoke": (chip_smoke.fig2_experiment(True),
                       fig2.experiment(True)),
        "fig2": (chip_smoke.fig2_experiment(), fig2.experiment()),
        "fig_dvfs": (chip_smoke.fig_dvfs_experiment(),
                     fig_dvfs.experiment()),
        "greendataflow": (chip_smoke.greendataflow_experiment(),
                          fig_dvfs.greendataflow()),
    }[name]
    t, j = port.cells(), ref.cells()
    assert [c.labels for c in t] == [c.labels for c in j]
    assert [c.scenario.name for c in t] == [c.scenario.name for c in j]
    assert [c.key for c in t] == [c.key for c in j]


def test_scenario_key_normalizes_spellings_as_in_jax():
    ds = tuple(ttypes.DatasetSpec(*d) for d in FAST)

    def sc(ctrl, **kw):
        return tapi.Scenario(profile=ttypes.CHAMELEON, datasets=ds,
                             controller=ctrl, total_s=TOTAL_S, **kw)

    assert tapi.scenario_key(sc("wget/curl")) == tapi.scenario_key(
        sc(tapi.make_controller("wget/curl"), name="labelled"))
    assert tapi.scenario_key(sc("wget/curl")) != tapi.scenario_key(
        sc("http/2"))
    assert tapi.scenario_key(sc(tapi.make_controller("eemt", max_ch=16))) \
        != tapi.scenario_key(sc(tapi.make_controller("eemt", max_ch=32)))
    jds = tuple(jtypes.DatasetSpec(*d) for d in FAST)
    for ctrl in ("wget/curl", "eett", "ismail-target"):
        j = japi.Scenario(profile=jtypes.CHAMELEON, datasets=jds,
                          controller=ctrl, total_s=TOTAL_S,
                          environment="lossy-wan")
        assert tapi.scenario_key(sc(ctrl, environment="lossy-wan")) == \
            japi.scenario_key(j), ctrl


@pytest.fixture(scope="module")
def reports():
    return (small_experiment(japi, jtypes).run(),
            small_experiment(tapi, ttypes).run(device="cpu"))


def test_report_equals_jax(reports):
    j, t = reports
    assert t.axes == j.axes and t.columns == j.columns
    for name in t.columns:
        if name in t.axes or name in ("completed", "time_s"):
            assert list(t[name]) == list(j[name]), name
        else:
            np.testing.assert_allclose(t[name], j[name], rtol=1e-6, atol=0,
                                       err_msg=name)
    assert t.meta["cells"] == 4 and t.meta["executed"] == 4


def test_report_rows_are_the_runs(reports):
    _, t = reports
    for cell, row in zip(small_experiment(tapi, ttypes).cells(), t.rows()):
        res = tapi.run(cell.scenario, device="cpu")
        for m in tapi.report.RESULT_METRICS:
            assert row[m] == float(getattr(res, m)), (cell.labels, m)


def test_cache_hit_resume_and_version(tmp_path):
    cache = str(tmp_path / "cells")
    calls = []

    def spy(scenarios):
        calls.append(len(scenarios))
        return tapi.sweep(scenarios, device="cpu")

    exp = small_experiment(tapi, ttypes)
    r1 = exp.run(cache=cache, sweeper=spy)
    assert calls == [4] and r1.meta["executed"] == 4
    r2 = small_experiment(tapi, ttypes).run(cache=cache, sweeper=spy)
    assert calls == [4]
    assert r2.meta["cache_hits"] == 4 and r2.meta["executed"] == 0
    victim = sorted(os.listdir(cache))[0]
    os.remove(os.path.join(cache, victim))
    r3 = exp.run(cache=cache, sweeper=spy)
    assert calls == [4, 1]
    assert r3.meta["cache_hits"] == 3 and r3.meta["executed"] == 1
    for m in r1.metrics:
        assert np.array_equal(r1[m], r2[m]) and np.array_equal(r1[m], r3[m])
    name = sorted(os.listdir(cache))[0]
    path = os.path.join(cache, name)
    payload = json.load(open(path))
    payload["version"] = "something/old"
    json.dump(payload, open(path, "w"))
    r4 = exp.run(cache=cache, device="cpu")
    assert r4.meta["executed"] == 1 and r4.meta["cache_hits"] == 3
    assert tapi.clear_cache(cache) == 4
    assert tapi.clear_cache(cache) == 0


def test_cache_serves_no_record_of_the_jax_package(tmp_path):
    """One directory may hold both packages' records under equal keys; the
    port treats the JAX package's as misses (and JAX, which checks only its
    version tag, would read the port's: that direction is JAX's own)."""
    from repro.api import experiments as jexp

    cache = str(tmp_path / "cells")
    calls = []

    def spy(scenarios):
        calls.append(len(scenarios))
        return tapi.sweep(scenarios, device="cpu")

    exp = small_experiment(tapi, ttypes)
    fake = {m: 0.0 for m in tapi.report.RESULT_METRICS}
    for cell in exp.cells():
        jexp._cache_write(cache, cell.key, dict(fake, name="jax"))
    rep = exp.run(cache=cache, sweeper=spy)
    assert calls == [4] and rep.meta["cache_hits"] == 0
    assert all(float(e) > 0.0 for e in rep["energy_j"])
    rep = exp.run(cache=cache, sweeper=spy)       # its own records hit
    assert calls == [4] and rep.meta["cache_hits"] == 4


def test_split_timing_runs_twice_and_needs_a_device(monkeypatch):
    import torch

    exp = small_experiment(tapi, ttypes)
    rep = exp.run(timing="split", device="cpu")
    assert {"wall_s", "warm_wall_s", "compile_s", "us_per_cell"} <= \
        set(rep.meta)
    with pytest.raises(ValueError, match="timing"):
        exp.run(timing="warm", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exp.run()
