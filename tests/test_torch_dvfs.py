"""The port's first-principles DVFS family (``repro_torch.core.dvfs``)
against the JAX package's (``repro.core.dvfs``): ``interp_f32`` against
``jnp.interp``, the matched-tables degeneration over the whole operating
lattice and the RUN_GOLDEN subset, the two executor-parity environments of
tests/test_dvfs.py against JAX op by op, the plain tick loop against the
Pallas kernel in interpret mode, and chip_smoke.py's copy of the fig_dvfs
and GreenDataFlow grids.

Exactness: everything is held bit for bit against JAX run op by op
(``jax.disable_jit()``).  ``jnp.interp`` is jitted inside JAX, and XLA may
contract ``fp + (delta / dx) * df`` into a fused multiply-add, so against
jitted JAX the interpolation is held to rtol 1e-6 (measured on the CPU:
one ulp, at most 1.2e-7, at 10-12 of 540 points off the nodes), and the
Pallas kernel in interpret mode, which XLA fuses too, to rtol 1e-6 as in
tests/test_torch_tick_loop.py.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import scenario as jscenario
from repro.core import dvfs as jdvfs
from repro.core import engine as jengine
from repro.core import tickstate as jts
from repro.core import types as jtypes
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import dvfs as tdvfs
from repro_torch.core import engine as tengine
from repro_torch.core import tickstate
from repro_torch.core import types as ttypes
from repro_torch.core._f32 import interp_f32
from repro_torch.kernels import tick_loop as tl

from torch_parity import (jax_kernel_loop_op_by_op, port_cpu,
                          port_environment, port_scenario, summary)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (RUN_GOLDEN; the fig_dvfs axes)

from benchmarks import fig_dvfs as jfig  # noqa: E402

CPU = ttypes.CpuProfile()
JCPU = jtypes.CpuProfile()
FAST = (jtypes.DatasetSpec("a", 200, 400.0, 2.0),
        jtypes.DatasetSpec("b", 10, 600.0, 60.0))
# tests/test_dvfs.py GOLDEN_SUBSET cells
SUBSET = [("chameleon", "eemt", "fast"), ("chameleon", "me", "fast"),
          ("chameleon", "wget/curl", "one"), ("cloudlab", "eett", "one")]


# ---------------------------------------------------------- interpolation --

def _interp_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for tech in ("hp", "lp"):
        t = jdvfs.DVFS_TECHS[tech]
        xp = np.asarray(t["vf_ghz"], np.float32)
        fp = np.asarray(t["vf_volt"], np.float32)
        x = np.concatenate([
            rng.uniform(0.2, 3.8, 512), xp, np.asarray(JCPU.freq_levels_ghz),
            np.nextafter(xp, np.float32(0)), np.nextafter(xp, np.float32(9)),
        ]).astype(np.float32)
        out[tech] = (x, xp, fp)
    return out


@pytest.mark.parametrize("tech", ["hp", "lp"])
def test_interp_f32_bit_equal_to_jnp_interp(tech):
    x, xp, fp = _interp_inputs()[tech]
    got = interp_f32(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(fp)).numpy()
    with jax.disable_jit():
        want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                     jnp.asarray(fp)))
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(jnp.interp(x, xp, fp))
    np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=0)
    # exact at the nodes, clamped outside the table
    node = interp_f32(torch.as_tensor(xp), torch.as_tensor(xp),
                      torch.as_tensor(fp)).numpy()
    np.testing.assert_array_equal(node, fp)
    edge = interp_f32(torch.tensor([0.01, 99.0]), torch.as_tensor(xp),
                      torch.as_tensor(fp)).numpy()
    np.testing.assert_array_equal(edge, fp[[0, -1]])


def test_const_table_is_cached_per_values_and_device():
    a = tickstate.const_table((1.0, 2.0, 3.0))
    assert a is tickstate.const_table((1.0, 2.0, 3.0), "cpu")
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert a.tolist() == [1.0, 2.0, 3.0]
    assert tickstate.const_table((0.1,)).item() == np.float32(0.1)


# ------------------------------------------------------- registry, knobs --

def test_presets_and_validation_mirror_jax():
    assert tdvfs.DVFS_TECHS == jdvfs.DVFS_TECHS
    assert tdvfs.IDLE_MODES == jdvfs.IDLE_MODES
    for tech in ("hp", "lp"):
        assert dataclasses.asdict(tdvfs.DvfsEnergyModel.for_tech(tech)) == \
            dataclasses.asdict(jdvfs.DvfsEnergyModel.for_tech(tech))
    assert dataclasses.asdict(tdvfs.DvfsEnergyModel.matched(CPU)) == \
        dataclasses.asdict(jdvfs.DvfsEnergyModel.matched(JCPU))
    bad = [dict(vf_ghz=(2.0, 1.0), vf_volt=(0.8, 0.9)),
           dict(vf_ghz=(1.0,), vf_volt=(0.8,)),
           dict(vf_ghz=(1.0, 2.0), vf_volt=(0.8, -0.9)),
           dict(cap_nf=0.0), dict(leak_w=-0.1), dict(n_big=0),
           dict(little_perf=0.0), dict(idle="sprint"),
           dict(idle_leak_frac=1.5), dict(max_freq_ghz=0.0)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jdvfs.DvfsEnergyModel(**kw)
        with pytest.raises(ValueError) as got:
            tdvfs.DvfsEnergyModel(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="unknown DVFS technology"):
        tapi.make_environment("dvfs", tech="sci-fi")


# ---------------------------------------------- matched-tables degeneration --

def test_matched_tables_bitwise_on_the_whole_lattice():
    """Every (cores, freq) point, at three loads and three throughputs, gives
    the reference model's watts, MB/s and load bit for bit."""
    matched, ref = tdvfs.DvfsEnergyModel.matched(CPU), \
        tapi.ReferenceEnergyModel()
    grid = np.meshgrid(np.arange(1, CPU.num_cores + 1, dtype=np.int32),
                       np.arange(len(CPU.freq_levels_ghz), dtype=np.int32),
                       np.float32([0.0, 0.37, 1.0]),
                       np.float32([0.0, 123.4, 1700.0]), indexing="ij")
    cores, fidx, util, tput = [torch.as_tensor(a.ravel()) for a in grid]
    c_m, f_m = matched.operating_point(CPU, cores, fidx)
    c_r, f_r = ref.operating_point(CPU, cores, fidx)
    assert torch.equal(c_m, c_r) and torch.equal(f_m, f_r)
    nch = torch.full_like(util, 8.0)
    assert torch.equal(matched.power_w(CPU, c_m, f_m, util, tput),
                       ref.power_w(CPU, c_r, f_r, util, tput))
    assert torch.equal(matched.cpu_capacity_mbps(CPU, c_m, f_m, nch),
                       ref.cpu_capacity_mbps(CPU, c_r, f_r, nch))
    assert torch.equal(matched.cpu_load(CPU, tput * 4, c_m, f_m, nch),
                       ref.cpu_load(CPU, tput * 4, c_r, f_r, nch))


def test_matched_tables_reproduce_run_goldens():
    env = tapi.Environment(network=tapi.DvfsNetworkModel(),
                           energy=tdvfs.DvfsEnergyModel.matched(CPU))
    cells = chip_smoke.golden_scenarios()
    swept = tapi.sweep([dataclasses.replace(cells[c], environment=env)
                        for c in SUBSET], device="cpu")
    for cell, r in zip(SUBSET, swept):
        assert (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
                r.avg_power_w) == chip_smoke.RUN_GOLDEN[cell], cell


def test_power_strictly_increases_in_frequency_on_the_ladder():
    f = torch.tensor(CPU.freq_levels_ghz, dtype=torch.float32)
    for tech in ("hp", "lp"):
        model = tdvfs.DvfsEnergyModel.for_tech(tech)
        for cores in (1, 4, 8):
            c = torch.full(f.shape, cores, dtype=torch.int32)
            w = model.power_w(CPU, c, f, torch.full_like(f, 0.7),
                              torch.full_like(f, 100.0))
            assert bool((w[1:] > w[:-1]).all()), (tech, cores)


def test_energy_model_surfaces_bitwise_vs_jax():
    """Capacity, load, power and J/MB of two non-degenerate models over the
    lattice, bit for bit against JAX op by op (the governor cap binds)."""
    models = [dict(tech="hp", idle="race", n_big=4),
              dict(tech="lp", max_freq_ghz=1.8, n_big=3)]
    c = np.repeat(np.arange(1, 9, dtype=np.int32), 7)
    fi = np.tile(np.arange(7, dtype=np.int32), 8)
    util = np.linspace(0.0, 1.0, c.size).astype(np.float32)
    tput = np.linspace(1.0, 1700.0, c.size).astype(np.float32)
    nch = np.full(c.size, 6.0, np.float32)
    t, j = torch.as_tensor, jnp.asarray
    for kw in models:
        jm = jdvfs.DvfsEnergyModel.for_tech(**kw)
        tm = tdvfs.DvfsEnergyModel.for_tech(**kw)
        with jax.disable_jit():
            jc, jf = jm.operating_point(JCPU, j(c), j(fi))
            want = [jc, jf, jm.cpu_capacity_mbps(JCPU, jc, jf, j(nch)),
                    jm.cpu_load(JCPU, j(tput), jc, jf, j(nch)),
                    jm.power_w(JCPU, jc, jf, j(util), j(tput)),
                    jm.energy_per_mb(JCPU, jc, jf, j(tput), j(nch))]
        tc, tf = tm.operating_point(CPU, t(c), t(fi))
        got = [tc, tf, tm.cpu_capacity_mbps(CPU, tc, tf, t(nch)),
               tm.cpu_load(CPU, t(tput), tc, tf, t(nch)),
               tm.power_w(CPU, tc, tf, t(util), t(tput)),
               tm.energy_per_mb(CPU, tc, tf, t(tput), t(nch))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ runs against JAX ----

ENV_KWARGS = [dict(tech="hp", idle="race", n_big=4),
              dict(tech="lp", max_freq_ghz=1.8)]


@pytest.mark.parametrize("env_kwargs", ENV_KWARGS,
                         ids=["hp-race-nbig4", "lp-cap1.8"])
def test_dvfs_runs_bit_exact_vs_jax_op_by_op(env_kwargs):
    """tests/test_dvfs.py:176-190's environments on its EEMT/FAST cell:
    final rows, all seven traces and the summary, bit for bit."""
    sc = japi.Scenario(profile=jtypes.CHAMELEON, datasets=FAST,
                       controller=japi.make_controller("eemt"),
                       environment=japi.make_environment("dvfs",
                                                         **env_kwargs),
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


def test_plain_version_vs_jax_pallas_interpret_under_dvfs():
    sc = japi.Scenario(profile=jtypes.CHAMELEON, datasets=FAST,
                       controller=japi.make_controller("eemt"),
                       environment=japi.make_environment("dvfs",
                                                         **ENV_KWARGS[0]),
                       total_s=240.0, dt=0.1)
    prep = jscenario._prepare(sc)
    k = prep.key
    runner = jengine.get_runner(k.ctrl_code, k.env_code, k.cpu, k.n_steps,
                                k.dt, k.ctrl_every, batched=False,
                                executor="pallas")
    sim, ts, jm = runner(prep.inputs)
    want_f, want_i = jts.TickLayout(k.n_partitions).pack_state(sim, ts,
                                                               xp=np)
    inp = convert.to_torch(jax.tree.map(lambda x: np.asarray(x)[None],
                                        prep.inputs), "cpu")
    env = port_environment(k.env_code)
    prow, f0, i0 = tengine.pack_batch(env, inp)
    ctrl = tapi.as_controller(port_scenario(sc).controller).code()
    f32, i32, m = tl.tick_loop_reference(ctrl, env, port_cpu(k.cpu), prow,
                                         inp.bw, f0, i0, dt=k.dt,
                                         ctrl_every=k.ctrl_every)
    np.testing.assert_array_equal(i32[0].numpy(), np.asarray(want_i))
    np.testing.assert_allclose(f32[0].numpy(), np.asarray(want_f), rtol=1e-6,
                               atol=0)
    for field, got, want in zip(ttypes.TickMetrics._fields, m, jm):
        got, want = got[0].numpy(), np.asarray(want)
        if field in ("cores", "freq_ghz", "done"):
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=field)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=field)


# --------------------------------------------- the fig_dvfs grids' axes ------

def _check_axes(ours, theirs, keys):
    assert len(ours) == len(theirs)
    by_label = {tuple(c.labels[k] for k in keys): c.scenario for c in theirs}
    for cell, sc in ours:
        want = port_scenario(by_label[cell])
        assert sc.name == want.name and sc.total_s == want.total_s, cell
        assert sc.dt == want.dt and sc.cpu == want.cpu, cell
        assert sc.profile == want.profile and sc.datasets == want.datasets
        assert tapi.as_environment(sc.environment) == want.environment, cell
        assert (tapi.as_controller(sc.controller)
                == tapi.as_controller(want.controller)), cell


def test_fig_dvfs_axes_are_the_benchmarks():
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fig_dvfs_full.json")) as f:
        gold = json.load(f)
    for ours, exp, keys, name in (
            (chip_smoke.fig_dvfs_scenarios(), jfig.experiment(smoke=False),
             ("tool", "fcap", "cores"), "fig_dvfs"),
            (chip_smoke.greendataflow_scenarios(), jfig.greendataflow(),
             ("testbed", "tech", "idle", "tool"), "greendataflow")):
        theirs = exp.cells()
        _check_axes(ours, theirs, keys)
        scs = [sc for _, sc in ours]
        assert tapi.group_count(scs) == japi.group_count(
            [c.scenario for c in theirs]) == gold[name]["group_count"]
        assert [tuple(r[k] for k in keys) for r in gold[name]["rows"]] == \
            [cell for cell, _ in ours]
