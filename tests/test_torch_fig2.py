"""Figure 2 through the port on the CPU, against the JAX package: the grid's
axes and grouping, the ``--smoke`` grid against JAX's ``api.sweep`` (and
its first 100 ticks bit for bit against JAX op by op), and the Chameleon
rows of ``tests/torch_goldens/fig2_full.json`` at their full budget.

Jitted JAX rounds some float32 results differently from its op-by-op
semantics, which the port follows (ROADMAP, queue 3), so whole-grid
comparisons hold the discrete results exactly and the float ones to a
stated tolerance.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from repro import api as japi
from repro.api import scenario as jscenario
from repro_torch import api as tapi

from torch_parity import jax_kernel_loop_op_by_op, port_scenario

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the port's copy of the Figure 2 axes)

from benchmarks import fig2 as jfig2  # noqa: E402

with open(os.path.join(ROOT, "tests", "torch_goldens",
                       "fig2_full.json")) as _f:
    FIG2_FULL = json.load(_f)


def _jax_fig2_cells(smoke):
    return jfig2.experiment(smoke=smoke).cells()


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_fig2_axes_are_the_benchmarks(smoke):
    ours = chip_smoke.fig2_scenarios(smoke=smoke)
    theirs = _jax_fig2_cells(smoke)
    assert len(ours) == len(theirs)
    by_label = {(c.labels["testbed"], c.labels["dataset"], c.labels["tool"]):
                c.scenario for c in theirs}
    for cell, sc in ours:
        want = port_scenario(by_label[cell])
        assert sc.name == want.name and sc.total_s == want.total_s
        assert sc.dt == want.dt and sc.cpu == want.cpu
        assert sc.profile == want.profile and sc.datasets == want.datasets
        assert (tapi.as_controller(sc.controller)
                == tapi.as_controller(want.controller)), cell


def test_group_count_matches_jax_on_fig2():
    ours = [sc for _, sc in chip_smoke.fig2_scenarios()]
    theirs = japi.group_count([c.scenario for c in _jax_fig2_cells(False)])
    assert tapi.group_count(ours) == theirs == FIG2_FULL["group_count"]
    assert tapi.group_count(ours, device="cpu") == theirs


def test_fig2_smoke_grid_vs_jax_sweep():
    """Cell for cell against JAX's jitted ``api.sweep``: the discrete
    results exactly, the float ones to XLA's fusion (rtol 1e-6)."""
    cells = _jax_fig2_cells(True)
    want = japi.sweep([c.scenario for c in cells])
    got = tapi.sweep([port_scenario(c.scenario) for c in cells],
                     device="cpu")
    for c, w, g in zip(cells, want, got):
        assert (g.completed, g.time_s) == (w.completed, w.time_s), c.labels
        np.testing.assert_allclose([g.energy_j, g.avg_tput_MBps],
                                   [w.energy_j, w.avg_tput_MBps], rtol=1e-6)
        for field, a, b in zip(g.metrics._fields, g.metrics, w.metrics):
            if field in ("cores", "freq_ghz", "done"):
                np.testing.assert_array_equal(a, b, err_msg=field)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=field)


def test_fig2_smoke_grid_prefix_bit_exact_vs_jax_op_by_op():
    """The first 10 s (100 ticks, 10 controller ticks) of every smoke cell,
    bit for bit against JAX op by op: final rows and all seven traces."""
    from repro_torch.api import scenario as S
    from repro_torch.core import tickstate

    cells = _jax_fig2_cells(True)
    scs = [dataclasses.replace(c.scenario, total_s=10.0) for c in cells]
    prepared, runs = tapi.run_groups([port_scenario(s) for s in scs],
                                     device="cpu")
    merged = S._merged_partition_counts([p.key for p in prepared])
    for run in runs:
        lay = tickstate.TickLayout(run.key.n_partitions)
        f32, i32 = lay.pack_state(run.sim, run.ts)
        for b, i in enumerate(run.indices):
            prep = jscenario._prepare(scs[i])
            assert merged[prepared[i].key] == run.key.n_partitions
            prep = prep._replace(
                key=prep.key._replace(n_partitions=run.key.n_partitions),
                inputs=jscenario.pad_partition_inputs(
                    prep.inputs, run.key.n_partitions))
            want_f, want_i, want_tr = jax_kernel_loop_op_by_op(prep)
            np.testing.assert_array_equal(f32[b].numpy(), want_f)
            np.testing.assert_array_equal(i32[b].numpy(), want_i)
            for field, got, want in zip(run.metrics._fields, run.metrics,
                                        want_tr):
                np.testing.assert_array_equal(
                    got[b].numpy(), want.astype(got[b].numpy().dtype), err_msg=field)


def test_fig2_chameleon_rows_vs_fig2_full_json():
    """The 24 Chameleon cells of Figure 2 at their 7,200 s budget, eagerly:
    completed and time_s exactly, energy and throughput to rtol 1e-5 (the
    JSON comes from jitted XLA)."""
    cells = [(c, sc) for c, sc in chip_smoke.fig2_scenarios()
             if c[0] == "chameleon"]
    rows = {(r["testbed"], r["dataset"], r["tool"]): r
            for r in FIG2_FULL["rows"]}
    got = tapi.sweep([sc for _, sc in cells], device="cpu")
    for (cell, _), r in zip(cells, got):
        want = rows[cell]
        assert (r.completed, r.time_s) == (want["completed"],
                                           want["time_s"]), cell
        np.testing.assert_allclose(
            [r.energy_j, r.avg_tput_MBps],
            [want["energy_j"], want["avg_tput_MBps"]], rtol=1e-5)
