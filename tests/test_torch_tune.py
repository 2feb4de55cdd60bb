"""repro_torch.api.tune against the JAX package's repro.api.tune on the CPU.

Every test of tests/test_tune.py has a counterpart: the same Experiment
grids (built in both packages from the same axes) go through both
``tune``s, which must pick the same winner (``best``, ``best_labels``),
``feasible`` flag and evaluation count, and report the same rows: labels
(axes, seed, round) exactly, metrics to ``JIT_RTOL`` (JAX sweeps jitted,
and XLA contracts float32 ops; the port follows JAX op by op, ROADMAP
queue 3).  The common-random-number bandwidth schedules are numpy and
equal bit for bit.
"""
import numpy as np
import pytest

from repro import api as japi
from repro.core import CpuProfile
from repro.core.types import CHAMELEON, DatasetSpec
from repro_torch import api as tapi
from torch_parity import port_cpu, port_datasets, port_profile

CPU = CpuProfile()
FAST = (DatasetSpec("a", 200, 400.0, 2.0),
        DatasetSpec("b", 10, 600.0, 60.0))
BIG = (DatasetSpec("a", 500, 200_000.0, 400.0),)
TOTAL_S = 120.0
MAX_CH = (4, 16, 64)
JIT_RTOL = 1e-5


def _base(api, datasets, total_s, controller):
    port = api is tapi
    return {"datasets": port_datasets(datasets) if port else datasets,
            "cpu": port_cpu(CPU) if port else CPU, "total_s": total_s,
            "profile": port_profile(CHAMELEON) if port else CHAMELEON,
            "controller": controller}


def tune_experiment(api):
    return api.Experiment(
        name="tune-t", space=api.grid(api.axis("max_ch", MAX_CH)),
        base=_base(api, FAST, TOTAL_S, lambda c: api.make_controller(
            "eemt", max_ch=c["max_ch"])))


def tradeoff_experiment(api):
    return api.Experiment(
        name="tradeoff-t",
        space=api.grid(api.axis("ctrl", ("me", "eemt", "wget/curl"))),
        base=_base(api, BIG, 60.0, lambda c: c["ctrl"]))


def chain_experiment(api):
    return api.Experiment(
        name="chain-t",
        space=api.chain(
            api.grid(api.axis("ctrl", ("eemt",)),
                     api.axis("max_ch", (8, 16))),
            api.axis("ctrl", ("me",))),
        base=_base(api, BIG, 60.0, lambda c: api.make_controller(
            c["ctrl"], **({} if c["max_ch"] is None
                          else {"max_ch": c["max_ch"]}))))


def both_tune(make, *args, **kw):
    """(JAX's TuneResult, the port's) of the same search."""
    return (japi.tune(make(japi), *args, **kw),
            tapi.tune(make(tapi), *args, device="cpu", **kw))


def assert_same_result(j, t):
    assert t.best == j.best and t.best_labels == j.best_labels
    assert (t.feasible, t.n_evals, t.objective, t.mode) == \
        (j.feasible, j.n_evals, j.objective, j.mode)
    assert abs(t.best_value - j.best_value) <= JIT_RTOL * abs(j.best_value)
    assert set(t.best_metrics) == set(j.best_metrics)
    for m, v in j.best_metrics.items():
        assert abs(t.best_metrics[m] - v) <= JIT_RTOL * abs(v) + 1e-12, m
    assert t.report.axes == j.report.axes
    assert t.report.columns == j.report.columns
    assert len(t.report) == len(j.report)
    for a in j.report.axes:
        assert list(t.report[a]) == list(j.report[a]), a
    for m in j.report.metrics:
        np.testing.assert_allclose(t.report[m], j.report[m], rtol=JIT_RTOL,
                                   atol=0, err_msg=m)
    tm, jm = dict(t.report.meta), dict(j.report.meta)
    assert tm == jm


@pytest.fixture(scope="module")
def exhaustive():
    """The ground truth of both packages: every cell swept."""
    return (tune_experiment(japi).run(),
            tune_experiment(tapi).run(device="cpu"))


def test_halving_returns_true_argmin(exhaustive):
    jtruth, truth = exhaustive
    assert truth.argbest("energy_j")["max_ch"] == \
        jtruth.argbest("energy_j")["max_ch"]
    j, t = both_tune(tune_experiment, "energy_j")
    assert_same_result(j, t)
    assert t.best_labels["max_ch"] == truth.argbest("energy_j")["max_ch"]
    assert t.best_value == truth.argbest("energy_j")["energy_j"]
    assert t.feasible
    j, t = both_tune(tune_experiment, "avg_tput_gbps", mode="max")
    assert_same_result(j, t)
    assert t.best_labels["max_ch"] == \
        truth.argbest("avg_tput_gbps", mode="max")["max_ch"]


def test_constraint_gates_the_winner():
    rows = tradeoff_experiment(tapi).run(device="cpu").rows()
    unconstrained = min(rows, key=lambda r: r["energy_j"])
    feas = [r for r in rows
            if r["avg_tput_gbps"] > unconstrained["avg_tput_gbps"]]
    assert feas
    floor = (unconstrained["avg_tput_gbps"]
             + min(r["avg_tput_gbps"] for r in feas)) / 2.0
    truth = min((r for r in rows if r["avg_tput_gbps"] >= floor),
                key=lambda r: r["energy_j"])
    j, t = both_tune(tradeoff_experiment, "energy_j",
                     ("avg_tput_gbps", ">=", floor))
    assert_same_result(j, t)
    assert truth["ctrl"] != unconstrained["ctrl"]
    assert t.best_labels["ctrl"] == truth["ctrl"]
    assert t.feasible
    assert t.best_metrics["avg_tput_gbps"] >= floor


def test_infeasible_everywhere_is_flagged():
    j, t = both_tune(tune_experiment, "energy_j",
                     ("avg_tput_gbps", ">=", 1e9))
    assert_same_result(j, t)
    assert not t.feasible


def test_crn_pairing_makes_tune_deterministic():
    j, a = both_tune(tune_experiment, "energy_j", seeds=[7, 11, 13])
    assert_same_result(j, a)
    b = tapi.tune(tune_experiment(tapi), "energy_j", seeds=[7, 11, 13],
                  device="cpu")
    assert a.best == b.best and a.best_value == b.best_value
    assert a.n_evals == b.n_evals and len(a.report) == len(b.report)
    for m in a.report.metrics:
        assert np.array_equal(a.report[m], b.report[m]), m
    for ax in a.report.axes:
        assert list(a.report[ax]) == list(b.report[ax])


@pytest.mark.parametrize("seed,n", [(7, 1200), (8, 1200), (0, 1), (3, 18000),
                                    (2 ** 31 - 1, 600)])
def test_crn_schedules_are_common_not_per_candidate(seed, n):
    """The seed alone determines the schedule, equal to JAX's bit for
    bit (numpy on both sides)."""
    s1 = tapi.crn_bw_schedule(seed, n)
    assert np.array_equal(s1, tapi.crn_bw_schedule(seed, n))
    assert s1.shape == (n,) and s1.dtype == np.float32
    assert float(s1.min()) >= 0.55 and float(s1.max()) <= 1.0
    j = japi.crn_bw_schedule(seed, n)
    assert j.dtype == s1.dtype and j.tobytes() == s1.tobytes()
    assert np.array_equal(tapi.crn_bw_schedule(seed, n, lo=0.2, hi=0.9),
                          japi.crn_bw_schedule(seed, n, lo=0.2, hi=0.9))
    if n > 1:
        assert not np.array_equal(s1, tapi.crn_bw_schedule(seed + 1, n))


def test_halving_search_report_accounts_every_eval():
    j, t = both_tune(tune_experiment, "energy_j", seeds=[7, 11], eta=3)
    assert_same_result(j, t)
    assert t.n_evals == len(t.report) == 4
    assert set(t.report.axes) == {"max_ch", "seed", "round"}
    winner = t.report.select(max_ch=t.best_labels["max_ch"])
    assert sorted(winner["seed"]) == ["11", "7"]


def test_refine_bisects_toward_better_configs(exhaustive):
    _, truth = exhaustive
    j, t = both_tune(tune_experiment, "energy_j", refine=2)
    assert_same_result(j, t)
    assert t.best_value <= truth.argbest("energy_j")["energy_j"]
    assert MAX_CH[0] <= t.best["max_ch"] <= MAX_CH[-1]
    assert isinstance(t.best["max_ch"], int)


def test_refine_survives_chain_winner_without_numeric_axis():
    j, t = both_tune(chain_experiment, "energy_j", refine=2)
    assert_same_result(j, t)
    assert t.best_labels["ctrl"] == "me"
    assert t.best["max_ch"] is None
    assert t.feasible


def test_tune_cache_serves_repeat_searches(tmp_path):
    cache = str(tmp_path / "cells")
    calls = []

    def spy(scenarios):
        calls.append(len(scenarios))
        return tapi.sweep(scenarios, device="cpu")

    first = tapi.tune(tune_experiment(tapi), "energy_j", sweeper=spy,
                      cache=cache, seeds=[7, 11])
    n_first = list(calls)
    again = tapi.tune(tune_experiment(tapi), "energy_j", sweeper=spy,
                      cache=cache, seeds=[7, 11])
    assert calls == n_first and sum(n_first) == first.n_evals
    assert again.best == first.best and again.n_evals == first.n_evals
    for m in first.report.metrics:
        assert np.array_equal(first.report[m], again.report[m]), m


def test_tune_validates_inputs():
    for api, kw in ((japi, {}), (tapi, {"device": "cpu"})):
        with pytest.raises(ValueError):
            api.tune(tune_experiment(api), "energy_j", mode="sideways", **kw)
        with pytest.raises(ValueError):
            api.tune(tune_experiment(api), "energy_j",
                     ("avg_tput_gbps", "~=", 1.0), **kw)
