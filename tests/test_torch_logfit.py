"""The port's logfit workload (``repro_torch.workloads.logfit``) against the
JAX package's (``repro.workloads.logfit``): parsing and fitting on
tests/test_workloads.py's cases and on random logs (host numpy on both
sides, so equal field for field), the registry, the constant-schedule
no-op through ``api.run`` (bit-equal to RUN_GOLDEN), and fitted schedules
through ``api.run`` against JAX op by op (bit for bit: the step is
``floor``, a table read and the reference physics)."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from repro import api as japi
from repro.api import scenario as jscenario
from repro.core import types as jtypes
from repro.workloads import logfit as jlf
from repro_torch import api as tapi
from repro_torch import workloads as tw
from repro_torch.core import tickstate

from torch_parity import jax_kernel_loop_op_by_op, port_scenario, summary

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  (the port's RUN_GOLDEN and its scenarios)


def _synth_records(schedule, bin_s=60.0):
    """One saturating transfer per bin (tests/test_workloads.py)."""
    return [dict(start_s=k * bin_s, end_s=(k + 1) * bin_s,
                 mb=bw * bin_s, rtt_s=0.04)
            for k, bw in enumerate(schedule)]


def _same_fit(ours, theirs):
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert type(ours).__name__ == type(theirs).__name__


def test_roundtrip_and_agg_modes_equal_jax():
    schedule = (800.0, 1200.0, 400.0, 1000.0)
    m = tw.fit_network_log(tw.load_transfer_log(_synth_records(schedule)))
    assert m.bw_mbps == schedule and m.rtt_s == 0.04
    _same_fit(m, jlf.fit_network_log(jlf.load_transfer_log(
        _synth_records(schedule))))
    recs = _synth_records((800.0,)) + [
        dict(start_s=120.0, end_s=180.0, mb=600.0 * 60.0),
        dict(start_s=120.0, end_s=180.0, mb=200.0 * 60.0)]
    for agg in ("sum", "max", "mean"):
        _same_fit(tw.fit_network_log(tw.load_transfer_log(recs), agg=agg),
                  jlf.fit_network_log(jlf.load_transfer_log(recs), agg=agg))
    assert tw.fit_network_log(tw.load_transfer_log(recs)).bw_mbps == \
        (800.0, 800.0, 800.0)


def test_random_logs_fit_as_jax():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n = int(rng.integers(1, 12))
        start = rng.uniform(0, 600, n)
        recs = [dict(start_s=float(s), duration_s=float(d), mb=float(mb),
                     **({"rtt_s": float(r)} if r > 0.05 else {}))
                for s, d, mb, r in zip(start, rng.uniform(0.5, 300, n),
                                       rng.uniform(1, 1e5, n),
                                       rng.uniform(0, 0.1, n))]
        bin_s = float(rng.choice([1.0, 7.5, 60.0]))
        agg = ("sum", "max", "mean")[trial % 3]
        _same_fit(tw.fit_network_log(tw.load_transfer_log(recs),
                                     bin_s=bin_s, agg=agg),
                  jlf.fit_network_log(jlf.load_transfer_log(recs),
                                      bin_s=bin_s, agg=agg))


def test_load_transfer_log_files_and_validation(tmp_path):
    recs = _synth_records((500.0, 700.0))
    jpath = tmp_path / "log.json"
    jpath.write_text(json.dumps(recs))
    assert tw.load_transfer_log(jpath) == tw.load_transfer_log(recs)
    cpath = tmp_path / "log.csv"
    cpath.write_text("start_s,duration_s,mb\n0,60,30000\n60,60,42000\n")
    (a, b) = tw.load_transfer_log(cpath)
    assert (a.rate_mbps, b.rate_mbps) == (500.0, 700.0)
    assert a.rtt_s is None
    assert [dataclasses.asdict(r) for r in tw.load_transfer_log(cpath)] == \
        [dataclasses.asdict(r) for r in jlf.load_transfer_log(cpath)]
    for bad, match in (([dict(start_s=0, end_s=1, mb=1, speed=9)],
                        "unknown fields"),
                       ([dict(start_s=0, mb=1)], "end_s"),
                       ([], "empty")):
        with pytest.raises(ValueError, match=match):
            tw.load_transfer_log(bad)
    with pytest.raises(ValueError):
        tw.LogRecord(start_s=1.0, end_s=1.0, mb=5.0)
    with pytest.raises(ValueError, match="agg"):
        tw.fit_network_log(tw.load_transfer_log(recs), agg="median")
    with pytest.raises(ValueError):
        tw.fit_network_log(())
    for kw in (dict(bin_s=0.0), dict(bw_mbps=()), dict(bw_mbps=(1.0, -2.0)),
               dict(rtt_s=0.0)):
        with pytest.raises(ValueError) as want:
            jlf.LogFitNetworkModel(**kw)
        with pytest.raises(ValueError) as got:
            tw.LogFitNetworkModel(**kw)
        assert str(got.value) == str(want.value)


def test_logfit_environment_registry():
    env = tapi.make_environment("logfit", log=_synth_records((600.0, 900.0)))
    assert env.network.name == "logfit" and env.name == "logfit+reference"
    assert env.network.bw_mbps == (600.0, 900.0)
    assert tapi.make_environment("logfit").network.bw_mbps == (1250.0,)
    with pytest.raises(ValueError, match="at most one"):
        tw.logfit_environment(log=[], model=env.network)
    recs = tw.load_transfer_log(_synth_records((300.0,)))
    assert tw.logfit_environment(recs).network.bw_mbps == (300.0,)


def test_schedule_table_is_the_const_table():
    m = tw.LogFitNetworkModel(bw_mbps=(800.0, 0.1))
    table = tickstate.const_table(m.bw_mbps)
    assert table.tolist() == [800.0, float(np.float32(0.1))]
    assert tickstate.const_table(m.bw_mbps) is table


def test_constant_schedule_is_a_bit_exact_noop():
    """A constant schedule at the profile's nominal bandwidth with no fitted
    RTT is the reference environment, on every RUN_GOLDEN cell."""
    cells = chip_smoke.golden_scenarios()
    scs = [dataclasses.replace(sc, environment=tw.LogFitNetworkModel(
        bw_mbps=(sc.profile.bandwidth_mbps,) * 3)) for sc in cells.values()]
    for cell, r in zip(cells, tapi.sweep(scs, device="cpu")):
        assert (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
                r.avg_power_w) == chip_smoke.RUN_GOLDEN[cell], cell


FITS = {"rtt": dict(bin_s=1.0),
        "no-rtt": dict(bin_s=0.5, model=jlf.LogFitNetworkModel(
            bin_s=0.5, bw_mbps=(900.0, 300.0, 1250.0, 600.0)))}


@pytest.mark.parametrize("fit", sorted(FITS))
def test_fitted_schedule_runs_bit_exact_vs_jax_op_by_op(fit):
    kw = dict(FITS[fit])
    if "model" not in kw:
        kw["log"] = _synth_records((800.0, 1200.0, 400.0, 1000.0),
                                   bin_s=kw["bin_s"])
    env = japi.make_environment("logfit", **kw)
    sc = japi.Scenario(
        profile=jtypes.CHAMELEON,
        datasets=(jtypes.DatasetSpec("a", 200, 400.0, 2.0),
                  jtypes.DatasetSpec("b", 10, 600.0, 60.0)),
        controller=japi.make_controller("eemt"), environment=env,
        total_s=240.0, dt=0.1)
    prep = jscenario._prepare(sc)
    want_f, want_i, want_tr = jax_kernel_loop_op_by_op(prep)
    _, runs = tapi.run_groups([port_scenario(sc)], device="cpu")
    r = runs[0]
    f32, i32 = tickstate.TickLayout(r.key.n_partitions).pack_state(r.sim,
                                                                   r.ts)
    np.testing.assert_array_equal(f32[0].numpy(), want_f)
    np.testing.assert_array_equal(i32[0].numpy(), want_i)
    for field, got, want in zip(r.metrics._fields, r.metrics, want_tr):
        np.testing.assert_array_equal(got[0].numpy(),
                                      want.astype(got[0].numpy().dtype),
                                      err_msg=field)
    res = tapi.run(port_scenario(sc), device="cpu")
    assert res.completed
    assert (res.completed, res.time_s, res.energy_j, res.avg_tput_MBps,
            res.avg_power_w) == summary(want_f, want_tr[-1], prep)
