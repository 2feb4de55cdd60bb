"""The port's environment families against the JAX package's: registries
and validation, the lossy-wan and big-little physics, every family through
``api.run`` on the FAST/ONE datasets, the degenerations and mixed sweeps
(dvfs: tests/test_torch_dvfs.py; logfit: tests/test_torch_logfit.py).

Exactness: big-little, lossy-wan without jitter and the degenerations are
bit-exact against JAX run op by op (its fused tick kernel's loop under
``jax.disable_jit()``: final rows and all seven traces).  Lossy-wan's RTT
jitter calls ``sin``, which PyTorch and XLA compute with different
routines on the CPU: there the discrete results (``completed``,
``time_s``, the int32 rows, the cores and done traces) are held exactly and
every float row and trace to LOSSY_RTOL of its largest magnitude (measured
on these cells: 6.1e-8 for the rows, 2.5e-7 for the traces).
"""
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import scenario as jscenario
from repro.core import types as jtypes
from repro_torch import api as tapi
from repro_torch.core import tickstate
from repro_torch.core import types as ttypes

from torch_parity import (jax_kernel_loop_op_by_op, port_environment,
                          port_scenario, summary)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  (the port's RUN_GOLDEN and its scenarios)

LOSSY_RTOL = 1e-6

FAST = (jtypes.DatasetSpec("a", 200, 400.0, 2.0),
        jtypes.DatasetSpec("b", 10, 600.0, 60.0))
ONE = (jtypes.DatasetSpec("c", 50, 500.0, 10.0),)
CELLS = {("chameleon", "eemt", "fast"): (jtypes.CHAMELEON, FAST),
         ("cloudlab", "eett", "one"): (jtypes.CLOUDLAB, ONE)}


def _scenario(cell, environment, **kw):
    profile, ds = CELLS[cell]
    ctrl = (japi.make_controller("eett", target_tput_mbps=400.0)
            if cell[1] == "eett" else japi.make_controller(cell[1]))
    return japi.Scenario(profile=profile, datasets=ds, controller=ctrl,
                         environment=environment, total_s=240.0, dt=0.1,
                         **kw)


def _port_rows(sc):
    """The port's final (f32, i32) rows and traces of one JAX scenario, on
    the CPU, as numpy."""
    _, runs = tapi.run_groups([port_scenario(sc)], device="cpu")
    r = runs[0]
    f32, i32 = tickstate.TickLayout(r.key.n_partitions).pack_state(r.sim,
                                                                   r.ts)
    return f32[0].numpy(), i32[0].numpy(), [m[0].numpy() for m in r.metrics]


def _names(names):
    # other test files register "test-*" entries in the JAX registries
    return {n for n in names if not n.startswith("test")}


# ------------------------------------------------------------- registries --

def test_registries_mirror_jax():
    assert _names(tapi.list_network_models()) == _names(
        japi.list_network_models()) == {"reference", "lossy-wan", "dvfs"}
    assert _names(tapi.list_energy_models()) == _names(
        japi.list_energy_models()) == {"reference", "big-little", "dvfs"}
    assert _names(tapi.list_environments()) == _names(
        japi.list_environments()) == {"reference", "lossy-wan", "big-little",
                                      "dvfs", "logfit"}


ENV_KWARGS = [
    ("reference", {}), ("lossy-wan", {}),
    ("lossy-wan", dict(loss_rate=1e-3, jitter_frac=0.2,
                       jitter_period_s=30.0)),
    ("big-little", {}), ("big-little", dict(n_big=2, little_perf=0.3)),
    ("dvfs", {}), ("dvfs", dict(tech="lp", idle="race", n_big=4)),
    ("dvfs", dict(max_freq_ghz=1.8)),
    ("logfit", {}),
    ("logfit", dict(log=[dict(start_s=0.0, end_s=60.0, mb=3.6e4,
                              rtt_s=0.05)], bin_s=30.0, agg="max")),
]


@pytest.mark.parametrize("name,kwargs", ENV_KWARGS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ENV_KWARGS)])
def test_make_environment_with_jax_kwargs(name, kwargs):
    ours = tapi.make_environment(name, **kwargs)
    theirs = japi.make_environment(name, **kwargs)
    assert ours == port_environment(theirs)
    assert ours.name == theirs.name
    assert isinstance(ours.network, tapi.NetworkModel)
    assert isinstance(ours.energy, tapi.EnergyModel)
    assert hash(ours.code()) == hash(ours.code())
    assert tapi.as_environment(ours) is ours


def test_model_registries_and_coercions():
    assert tapi.make_network_model("LOSSY-WAN", loss_rate=1e-3) == \
        tapi.LossyWanNetworkModel(loss_rate=1e-3)
    assert tapi.make_energy_model("big-little", n_big=2) == \
        tapi.BigLittleEnergyModel(n_big=2)
    assert tapi.make_energy_model("dvfs", tech="lp") == \
        tapi.DvfsEnergyModel.for_tech("lp")
    env = tapi.as_environment(tapi.LossyWanNetworkModel())
    assert isinstance(env.energy, tapi.ReferenceEnergyModel)
    env = tapi.as_environment(tapi.BigLittleEnergyModel())
    assert isinstance(env.network, tapi.ReferenceNetworkModel)
    assert tapi.make_environment("lossy-wan").name == "lossy-wan+reference"
    assert tapi.make_environment("big-little").name == "reference+big-little"
    with pytest.raises(TypeError):
        tapi.make_network_model("dvfs", tech="hp")  # knobs live on energy
    with pytest.raises(TypeError):
        tapi.make_environment("reference", loss_rate=0.1)


BAD = [
    (tapi.LossyWanNetworkModel, japi.LossyWanNetworkModel,
     dict(loss_rate=-1.0)),
    (tapi.LossyWanNetworkModel, japi.LossyWanNetworkModel,
     dict(jitter_frac=1.5)),
    (tapi.LossyWanNetworkModel, japi.LossyWanNetworkModel,
     dict(jitter_period_s=0.0)),
    (tapi.BigLittleEnergyModel, japi.BigLittleEnergyModel, dict(n_big=0)),
    (tapi.BigLittleEnergyModel, japi.BigLittleEnergyModel,
     dict(little_perf=0.0)),
    (tapi.BigLittleEnergyModel, japi.BigLittleEnergyModel,
     dict(little_static_frac=1.5)),
]


@pytest.mark.parametrize("ours,theirs,kwargs", BAD,
                         ids=[str(i) for i in range(len(BAD))])
def test_hyperparameters_are_validated_as_jax(ours, theirs, kwargs):
    with pytest.raises(ValueError) as want:
        theirs(**kwargs)
    with pytest.raises(ValueError) as got:
        ours(**kwargs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- physics --

def test_lossy_wan_constants_are_jaxs_float32():
    m = tapi.LossyWanNetworkModel(loss_rate=1e-3, jitter_period_s=30.0)
    # the JAX package's Python double expressions (environments.py:235-244)
    assert m.window_cap() == 1.22 * (1500.0 / (1024.0 * 1024.0)) \
        / math.sqrt(1e-3)
    assert m.knee_divisor() == 1.0 + 4.0 * math.sqrt(1e-3)
    assert m.jitter_rate() == 2.0 * math.pi / 30.0


@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_lossy_wan_step_vs_jax(jitter):
    """One lossy step from a mid-transfer state, against JAX op by op."""
    from repro.core.types import NetParams, TransferParams

    kw = dict(loss_rate=1e-3, jitter_frac=jitter, jitter_period_s=30.0)
    jm, tm = japi.LossyWanNetworkModel(**kw), tapi.LossyWanNetworkModel(**kw)
    net = NetParams.from_profile(jtypes.CHAMELEON)
    rem = np.asarray([100.0, 37.5], np.float32)
    win = np.asarray([0.7, 1.9], np.float32)
    with jax.disable_jit():
        st = jtypes.SimState(jnp.asarray(rem), jnp.asarray(win),
                             jnp.float32(7.3), jnp.float32(11.0),
                             jnp.float32(5.0))
        params = TransferParams(pp=jnp.ones((2,)), par=jnp.full((2,), 2.0),
                                cc=jnp.asarray([3.0, 1.0]),
                                cores=jnp.asarray(6, jnp.int32),
                                freq_idx=jnp.asarray(4, jnp.int32))
        s2, out = jm.step(japi.ReferenceEnergyModel(), net,
                          jtypes.CpuProfile(), st, params,
                          jnp.asarray([10.0, 2.0]), 0.1, 0.9)
    t = torch.as_tensor
    tnet = ttypes.NetParams(*[t(np.asarray(x))[None] for x in net])
    tst = ttypes.SimState(t(rem)[None], t(win)[None], t([7.3]), t([11.0]),
                          t([5.0]))
    tparams = ttypes.TransferParams(
        pp=torch.ones(1, 2), par=torch.full((1, 2), 2.0),
        cc=t([[3.0, 1.0]]), cores=t([6], dtype=torch.int32),
        freq_idx=t([4], dtype=torch.int32))
    ts2, tout = tm.step(tapi.ReferenceEnergyModel(), tnet,
                        ttypes.CpuProfile(), tst, tparams,
                        t([[10.0, 2.0]]), 0.1, t([0.9]))
    for want, got in zip([*s2, *out], [*ts2, *tout]):
        want = np.asarray(want)
        got = got[0].numpy()
        if jitter == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=LOSSY_RTOL, atol=0)


def test_big_little_surfaces_bitwise_vs_jax():
    """Capacity, load and power of big-little over the whole operating
    lattice, bit for bit against JAX op by op."""
    cpu = jtypes.CpuProfile()
    jm, tm = japi.BigLittleEnergyModel(n_big=3), tapi.BigLittleEnergyModel(
        n_big=3)
    cores = np.arange(1, cpu.num_cores + 1, dtype=np.int32)
    freqs = np.asarray(cpu.freq_levels_ghz, np.float32)
    c, f = [a.ravel() for a in np.meshgrid(cores, freqs, indexing="ij")]
    nch = np.full(c.shape, 8.0, np.float32)
    tput = np.linspace(0.0, 1700.0, c.size).astype(np.float32)
    util = np.linspace(0.0, 1.0, c.size).astype(np.float32)
    tcpu = ttypes.CpuProfile()
    t = torch.as_tensor
    j = jnp.asarray
    with jax.disable_jit():
        want = [jm.cpu_capacity_mbps(cpu, j(c), j(f), j(nch)),
                jm.cpu_load(cpu, j(tput), j(c), j(f), j(nch)),
                jm.power_w(cpu, j(c), j(f), j(util), j(tput))]
    got = [tm.cpu_capacity_mbps(tcpu, t(c), t(f), t(nch)),
           tm.cpu_load(tcpu, t(tput), t(c), t(f), t(nch)),
           tm.power_w(tcpu, t(c), t(f), t(util), t(tput))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ api.run against JAX ------

FAMILIES = {
    "lossy-wan": "lossy-wan",
    "lossy-wan-loss-only": japi.LossyWanNetworkModel(loss_rate=1e-3,
                                                     jitter_frac=0.0),
    "big-little": japi.BigLittleEnergyModel(n_big=2),
}


@pytest.mark.parametrize("cell", sorted(CELLS), ids="/".join)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_runs_match_jax_op_by_op(family, cell):
    sc = _scenario(cell, FAMILIES[family])
    prep = jscenario._prepare(sc)
    want_f, want_i, want_tr = jax_kernel_loop_op_by_op(prep)
    f32, i32, traces = _port_rows(sc)
    np.testing.assert_array_equal(i32, want_i)
    exact = family != "lossy-wan"
    for field, got, want in zip(["f32", *ttypes.TickMetrics._fields],
                                [f32, *traces], [want_f, *want_tr]):
        want = want.astype(got.dtype)
        if exact or field in ("cores", "done"):
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=LOSSY_RTOL * float(np.abs(want).max()), err_msg=field)
    r = tapi.run(port_scenario(sc), device="cpu")
    got = (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps, r.avg_power_w)
    want = summary(want_f, want_tr[-1], prep)
    if exact:
        assert got == want
    else:
        assert got[:2] == want[:2]
        np.testing.assert_allclose(got[2:], want[2:], rtol=LOSSY_RTOL)


DEGENERATE = {
    "lossy-wan-clean": tapi.LossyWanNetworkModel(loss_rate=0.0,
                                                 jitter_frac=0.0),
    "big-little-all-big": tapi.BigLittleEnergyModel(n_big=8),
}


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_degenerations_are_the_reference_bit_for_bit(name):
    cells = chip_smoke.golden_scenarios()
    swept = tapi.sweep([dataclasses.replace(sc, environment=DEGENERATE[name])
                        for sc in cells.values()], device="cpu")
    for cell, r in zip(cells, swept):
        assert (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
                r.avg_power_w) == chip_smoke.RUN_GOLDEN[cell], cell


def test_mixed_environment_sweep_groups_as_jax():
    envs = [None, "reference", "lossy-wan", "big-little",
            japi.LossyWanNetworkModel(loss_rate=1e-3)]
    jscs = [_scenario(("chameleon", "eemt", "fast"), e) for e in envs]
    tscs = [port_scenario(s) for s in jscs]
    assert tapi.group_count(tscs) == tapi.group_count(
        tscs, device="cpu") == japi.group_count(jscs) == 4
    swept = tapi.sweep(tscs, device="cpu")
    assert all(r.completed for r in swept)
    assert swept[0].energy_j == swept[1].energy_j
    assert swept[2].energy_j != swept[0].energy_j
    for sc, r in zip(tscs, swept):
        one = tapi.run(sc, device="cpu")
        assert (one.time_s, one.energy_j) == (r.time_s, r.energy_j)
        for a, b in zip(one.metrics, r.metrics):
            assert np.array_equal(a, b)
