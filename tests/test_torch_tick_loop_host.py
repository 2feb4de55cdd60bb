"""The CUDA tick-loop source on the CPU, for every environment family:
``csrc/tick_loop.cu`` compiled whole with g++ against a stub CUDA runtime
(tests/tick_host/: each block's threads run one after another), under
FTZ | DAZ and without contraction (``-ffp-contract=off``; x86-64 g++ emits
no fused multiply-add without ``-mfma``) — the kernel's ``-ftz=true
-fmad=false`` — and launched through the wrapper's own argument marshalling
(``tick_loop.marshal_and_launch``).  Held to the plain version
(``tick_loop_reference``) bit for bit: final rows and all seven traces.

The learned controller (``repro_torch.learn``) runs the same way: the
block stages the MLP's weight table into shared memory (here the block's
threads run as std::threads meeting at ``__syncthreads``) and every lane
featurizes, runs the MLP in the plain version's order and applies its
actions.  glibc's ``tanhf`` / ``log1pf`` / ``log10f`` stand in for
libdevice's and PyTorch's CPU functions for the plain version's; the runs
below are held bit for bit all the same (measured: equal; a last-bit
difference could only show through a flipped near-tie argmax).

One exception: lossy-wan's jitter calls the C library's ``sinf`` here and
``torch.sin`` in the plain version, two routines on the CPU (on the card
both are libdevice's ``sinf``: tests/test_torch_gpu.py holds them
bit-equal there).  Its groups are held to rtol 1e-5 of each tensor's
largest magnitude, with the int32 rows and the cores and done traces
exact (measured: 2.4e-7).
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import scenario as S
from repro_torch.core import engine
from repro_torch.core.types import (CHAMELEON, CLOUDLAB, CpuProfile,
                                    DatasetSpec)
from repro_torch.kernels import tick_loop as tl

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "src", "repro_torch", "kernels", "csrc")
JITTER_RTOL = 1e-5

FAST = (DatasetSpec("a", 200, 400.0, 2.0), DatasetSpec("b", 10, 600.0, 60.0))
ONE = (DatasetSpec("c", 50, 500.0, 10.0),)
LOG = [dict(start_s=k * 2.0, end_s=(k + 1) * 2.0, mb=bw * 2.0, rtt_s=0.04)
       for k, bw in enumerate((800.0, 1200.0, 400.0, 1000.0))]


@pytest.fixture(scope="module")
def host_launch(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the tick-loop source for the host")
    lib = tmp_path_factory.mktemp("tick_host") / "libtick_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-pthread",
                    "-I", os.path.join(HERE, "tick_host"), "-I", CSRC,
                    "-o", str(lib), os.path.join(HERE, "tick_host",
                                                 "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).host_tick_loop_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 3 + [ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


ENVIRONMENTS = {
    "reference": None,
    "lossy-wan": "lossy-wan",
    "lossy-wan-clean": api.LossyWanNetworkModel(loss_rate=0.0,
                                                jitter_frac=0.0),
    "lossy-wan-loss": api.LossyWanNetworkModel(loss_rate=1e-3,
                                               jitter_frac=0.0),
    "big-little": api.make_environment("big-little", n_big=4),
    "dvfs-hp-race": api.make_environment("dvfs", tech="hp", idle="race",
                                         n_big=4),
    "dvfs-lp-capped": api.make_environment("dvfs", tech="lp",
                                           max_freq_ghz=1.8),
    "dvfs-matched": api.Environment(
        network=api.DvfsNetworkModel(),
        energy=api.DvfsEnergyModel.matched(CpuProfile())),
    "logfit": api.make_environment("logfit", log=LOG, bin_s=2.0),
    "logfit-constant": api.make_environment("logfit"),
    "lossy-wan+dvfs": api.Environment(
        network=api.LossyWanNetworkModel(loss_rate=1e-3, jitter_frac=0.0),
        energy=api.DvfsEnergyModel.for_tech("lp", idle="race")),
    "logfit+big-little": api.Environment(
        network=api.make_environment("logfit", log=LOG, bin_s=2.0).network,
        energy=api.BigLittleEnergyModel(n_big=2)),
}
CONTROLLERS = [api.make_controller("ME"), api.make_controller("EEMT"),
               api.make_controller("EEMT", scaling=False),
               api.make_controller("EETT", target_tput_mbps=400.0),
               api.make_controller("ismail-target", target_tput_mbps=400.0),
               "wget/curl"]


@pytest.mark.parametrize("name", sorted(ENVIRONMENTS))
def test_kernel_source_equals_plain_version(host_launch, name):
    env = ENVIRONMENTS[name]
    scs = [api.Scenario(profile=prof, datasets=ds, controller=c,
                        environment=env, total_s=20.0, dt=0.1)
           for prof, ds in ((CHAMELEON, FAST), (CLOUDLAB, ONE))
           for c in CONTROLLERS]
    prepared, groups = S._prepare_groups(scs, torch.device("cpu"))
    jitter = name == "lossy-wan"
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        args = (key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0)
        kw = dict(dt=key.dt, ctrl_every=key.ctrl_every)
        err, got = tl.marshal_and_launch(host_launch, *args, **kw,
                                         stream=None)
        assert err == 0
        want = tl.tick_loop_reference(*args, **kw)
        for field, a, b in zip(["f32", "i32", *want[2]._fields],
                               [got[0], got[1], *got[2]],
                               [want[0], want[1], *want[2]]):
            if jitter and a.dtype == torch.float32:
                tol = JITTER_RTOL * max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= tol, (key, field)
            else:
                assert torch.equal(a, b), (name, key.ctrl_code, field)


def _random_policy(hidden, scale, seed):
    """Seeded numpy MLP weights ``1/sqrt(fan_in) * scale`` normal, biases
    0.1 normal: large scales make the heads move often."""
    rng = np.random.default_rng(seed)
    sizes = (9, *hidden, 9)
    params = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = (rng.normal(size=(n_in, n_out)) * scale
                           / np.sqrt(n_in)).astype(np.float32)
        params[f"b{i}"] = (rng.normal(size=n_out) * 0.1).astype(np.float32)
    return params


POLICIES = {"32x32": ((32, 32), 1.0), "32x32-x3": ((32, 32), 3.0),
            "64": ((64,), 2.0), "16x8x24": ((16, 8, 24), 2.0)}
BIG = (DatasetSpec("d", 100, 40000.0, 400.0),)


def _check_equal(host_launch, scs):
    prepared, groups = S._prepare_groups(scs, torch.device("cpu"))
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, "cpu")
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        args = (key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0)
        kw = dict(dt=key.dt, ctrl_every=key.ctrl_every)
        err, got = tl.marshal_and_launch(host_launch, *args, **kw,
                                         stream=None)
        assert err == 0
        want = tl.tick_loop_reference(*args, **kw)
        for field, a, b in zip(["f32", "i32", *want[2]._fields],
                               [got[0], got[1], *got[2]],
                               [want[0], want[1], *want[2]]):
            assert torch.equal(a, b), (key.ctrl_code.name, field)
    return want


@pytest.mark.parametrize("env", ["reference", "dvfs-hp-race",
                                 "lossy-wan-loss", "logfit"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_learned_kernel_source_equals_plain_version(host_launch, policy,
                                                    env):
    from repro_torch.learn import LearnedController

    hidden, scale = POLICIES[policy]
    ctrl = LearnedController(params=_random_policy(hidden, scale, 0))
    scs = [api.Scenario(profile=prof, datasets=ds, controller=ctrl,
                        environment=ENVIRONMENTS[env], total_s=20.0, dt=0.1)
           for prof, ds in ((CHAMELEON, FAST), (CLOUDLAB, ONE),
                            (CHAMELEON, BIG))]
    want = _check_equal(host_launch, scs)
    # fsm counts the controller ticks the lanes ran
    assert int(want[1][:, 0].max()) >= 10


def test_launch_rejects_arguments_no_instance_takes(host_launch,
                                                    monkeypatch):
    sc = api.Scenario(profile=CHAMELEON, datasets=ONE, controller="EEMT",
                      environment=ENVIRONMENTS["dvfs-hp-race"], total_s=1.0)
    prepared, groups = S._prepare_groups([sc], torch.device("cpu"))
    (key, idxs), = groups.items()
    inp = S._stack_group(prepared, idxs, "cpu")
    prow, f0, i0 = engine.pack_batch(key.env_code, inp)
    spec = tl.kernel_spec(key.ctrl_code, key.env_code)[2]

    def call(codes):
        bad = spec._replace(codes=tuple(codes))
        monkeypatch.setattr(tl, "env_spec", lambda env: bad)
        return tl.marshal_and_launch(
            host_launch, key.ctrl_code, key.env_code, key.cpu, prow, inp.bw,
            f0, i0, dt=key.dt, ctrl_every=key.ctrl_every, stream=None)[0]

    codes = dict(zip(tl.ENV_CODES, spec.codes))
    assert call(spec.codes) == 0
    for change in (dict(n_vf=1), dict(n_vf=tl.MAX_VF_POINTS + 1),
                   dict(network=3), dict(energy=-1),
                   dict(network=tl.NET_LOGFIT, n_bins=0)):
        assert call([{**codes, **change}[k] for k in tl.ENV_CODES]) != 0, \
            change


def test_launch_rejects_policies_no_instance_takes(host_launch,
                                                   monkeypatch):
    from repro_torch.learn import LearnedController

    ctrl = LearnedController()
    sc = api.Scenario(profile=CHAMELEON, datasets=ONE, controller=ctrl,
                      total_s=1.0)
    prepared, groups = S._prepare_groups([sc], torch.device("cpu"))
    (key, idxs), = groups.items()
    inp = S._stack_group(prepared, idxs, "cpu")
    prow, f0, i0 = engine.pack_batch(key.env_code, inp)

    table = torch.zeros(10000)
    monkeypatch.setattr(LearnedController, "table",
                        lambda self, device: table)

    def call(widths):
        monkeypatch.setattr(tl, "policy_widths", lambda c: tuple(widths))
        return tl.marshal_and_launch(
            host_launch, key.ctrl_code, key.env_code, key.cpu, prow, inp.bw,
            f0, i0, dt=key.dt, ctrl_every=key.ctrl_every, stream=None)[0]

    assert call((9, 32, 32, 9)) == 0
    for widths in ((9, 32, 32, 8), (10, 32, 32, 9), (9, 65, 9),
                   (9, 8, 8, 8, 8, 9), (9, 0, 9)):
        assert call(widths) != 0, widths
