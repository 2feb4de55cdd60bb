"""The port's public surface, end to end on the CPU: RUN_GOLDEN through
``repro_torch.api.run``, sweep == runs, the device/executor rules, and the
port's independence from JAX (Figure 2: tests/test_torch_fig2.py).

The JAX package's jitted results are not bit-level oracles: XLA fuses the
float32 ops of a tick and rounds differently from JAX's op-by-op semantics,
which the port follows.  Five RUN_GOLDEN cells differ that way in the last
bits of one field; they are held to the op-by-op values (ROADMAP, queue 3).
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import scenario as jscenario
from repro_torch import api as tapi
from repro_torch.core import engine as tengine

from test_environments import RUN_GOLDEN
from torch_parity import (jax_kernel_loop_op_by_op, port_datasets,
                          port_profile, summary)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the port's copies of the goldens and axes)

# RUN_GOLDEN cells whose jitted values differ from JAX's op-by-op semantics.
OP_BY_OP = {("chameleon", "me", "fast"), ("chameleon", "me", "one"),
            ("cloudlab", "eemt", "one"), ("cloudlab", "me", "fast"),
            ("cloudlab", "wget/curl", "fast")}


def _fields(r):
    return (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
            r.avg_power_w)


@pytest.fixture(scope="module")
def golden_runs():
    cells = chip_smoke.golden_scenarios()
    return {cell: tapi.run(sc, device="cpu") for cell, sc in cells.items()}


@pytest.mark.parametrize("cell", sorted(RUN_GOLDEN), ids="/".join)
def test_run_golden_bit_exact(cell, golden_runs):
    assert _fields(golden_runs[cell]) == chip_smoke.RUN_GOLDEN[cell]


def test_golden_table_is_jaxs_outside_the_op_by_op_cells():
    assert set(chip_smoke.RUN_GOLDEN) == set(RUN_GOLDEN)
    for cell in RUN_GOLDEN:
        same = chip_smoke.RUN_GOLDEN[cell] == RUN_GOLDEN[cell]
        assert same == (cell not in OP_BY_OP), cell


@pytest.mark.parametrize("cell", sorted(OP_BY_OP), ids="/".join)
def test_op_by_op_golden_cells_are_jax_op_by_op(cell):
    """The five cells' table values are what JAX computes op by op (its
    fused tick kernel's loop under disable_jit) — not a port artefact."""
    pn, cn, dn = cell
    jsc = chip_smoke.golden_scenarios()[cell]
    ctrl = (japi.make_controller(cn, target_tput_mbps=400.0)
            if cn in ("eett", "ismail-target") else japi.make_controller(cn))
    from repro.core import types as jtypes
    prep = jscenario._prepare(japi.Scenario(
        profile=jtypes.TESTBEDS[pn],
        datasets=tuple(jtypes.DatasetSpec(*dataclasses.astuple(d))
                       for d in jsc.datasets),
        controller=ctrl, total_s=240.0, dt=0.1))
    f32, _, traces = jax_kernel_loop_op_by_op(prep)
    assert summary(f32, traces[-1], prep) == chip_smoke.RUN_GOLDEN[cell]
    assert chip_smoke.RUN_GOLDEN[cell] != RUN_GOLDEN[cell]


def test_sweep_equals_runs(golden_runs):
    cells = chip_smoke.golden_scenarios()
    swept = tapi.sweep(list(cells.values()), device="cpu")
    assert len(swept) == len(cells)
    for cell, r in zip(cells, swept):
        one = golden_runs[cell]
        assert _fields(r) == _fields(one), cell
        for a, b in zip(r.metrics, one.metrics):
            assert np.array_equal(a, b), cell


# --------------------------------------------------- devices and executors --

def _one_scenario(**kw):
    from repro_torch.core.types import CHAMELEON, DatasetSpec
    return tapi.Scenario(profile=CHAMELEON,
                         datasets=(DatasetSpec("c", 50, 500.0, 10.0),),
                         controller="eemt", total_s=2.0, **kw)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tapi.run(_one_scenario()),
                 lambda: tapi.sweep([_one_scenario()]),
                 lambda: tapi.run(_one_scenario(), device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tapi.run(_one_scenario(), device="cpu").completed


def test_executor_resolution():
    assert tengine.resolve_executor("auto", "cuda") == "cuda"
    assert tengine.resolve_executor("auto", "cpu") == "reference"
    assert tengine.resolve_executor("reference", "cuda") == "reference"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tengine.resolve_executor("cuda", "cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tapi.run(_one_scenario(executor="cuda"), device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        _one_scenario(executor="pallas")


def test_runner_cache_keys_and_clear():
    args = (tapi.make_controller("EEMT").code(),
            tapi.as_environment(None).code(),
            chip_smoke.golden_scenarios()[("chameleon", "eemt", "one")].cpu,
            2400, 0.1, 10)
    tengine.clear_runner_caches()
    r1 = tengine.get_runner(*args, "reference")
    assert tengine.get_runner(*args, "reference") is r1
    assert tengine.get_runner(*args, "cuda") is not r1
    assert tengine.runner_cache_sizes() == {"runner": 2}
    tengine.clear_runner_caches()
    assert tengine.runner_cache_sizes() == {"runner": 0}


# ------------------------------------------------------- independence ------

def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.api, repro_torch.convert, "
            "repro_torch.kernels.tick_loop, repro_torch.kernels.build, "
            "repro_torch.kernels.flash_attention, repro_torch.models, "
            "repro_torch.kernels.rwkv6, repro_torch.kernels.rglru, "
            "repro_torch.models.rwkv6, repro_torch.models.rglru, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.train, repro_torch.train.trainer, "
            "repro_torch.optim, repro_torch.ckpt, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.core.dvfs, "
            "repro_torch.workloads, repro_torch.workloads.logfit, "
            "repro_torch.learn, repro_torch.api.experiments, "
            "repro_torch.api.report, repro_torch.fleet.ringbuf, "
            "repro_torch.fleet.online, repro_torch.workloads.faults, "
            "repro_torch.workloads.http, repro_torch.ckpt.tuned_writer; "
            "from repro_torch import api; "
            "[api.make_environment(n) for n in api.list_environments()]; "
            "from repro_torch.configs import ARCHS, get_config; "
            "[get_config(a) for a in ARCHS]; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_import_no_jax_and_no_repro():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_torch)|import\s+repro\.|from\s+repro\b(?!_torch)"
                     r"|from\s+repro\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for module in ("core/dvfs.py", "api/environments.py",
                   "workloads/__init__.py", "workloads/logfit.py",
                   "api/report.py", "api/experiments.py",
                   "learn/__init__.py", "learn/policy.py",
                   "learn/controller.py", "learn/rollout.py",
                   "learn/train.py", "learn/evaluate.py",
                   "fleet/ringbuf.py", "fleet/online.py",
                   "workloads/faults.py", "workloads/http.py",
                   "ckpt/tuned_writer.py"):
        assert os.path.join(ROOT, "src", "repro_torch", module) in files
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not bad.search(text), path


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        dst = tmp_path / "chip_smoke.py"
        dst.write_text(open(script).read())
        script = str(dst)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, env=env, timeout=120,
                         cwd=os.path.dirname(script))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_convert_round_trips_jax_inputs():
    from repro_torch import convert

    sc = chip_smoke.golden_scenarios()[("chameleon", "eemt", "fast")]
    from repro.core import types as jtypes
    prep = jscenario._prepare(japi.Scenario(
        profile=jtypes.CHAMELEON,
        datasets=tuple(jtypes.DatasetSpec(*dataclasses.astuple(d))
                       for d in sc.datasets),
        controller="eemt", total_s=240.0))
    ti = convert.to_torch(prep.inputs)
    assert type(ti) is tengine.ScanInputs
    back = convert.to_numpy(ti, like=type(prep.inputs))
    for a, b in zip(jax.tree.leaves(prep.inputs), jax.tree.leaves(
            tuple(back))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
    assert port_profile(jtypes.CHAMELEON) == sc.profile
    jds = tuple(jtypes.DatasetSpec(*dataclasses.astuple(d))
                for d in sc.datasets)
    assert port_datasets(jds) == sc.datasets
