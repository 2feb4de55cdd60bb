"""The fleet's wave contract in the port (``engine.build_wave_core``,
``build_blocked_wave_core``, ``get_wave_runner``; the tick kernel's wave
mode) against the JAX package on the CPU.

* The admission rows: the port's ``fleet.admission.Combo`` packs the same
  parameter and tick-0 state rows as JAX's, bit for bit.
* The plain wave (``tick_loop.tick_wave_reference``) against JAX's
  ``build_blocked_wave_core`` run op by op (``jax.disable_jit()``), wave by
  wave from the same rows, with every lane's ``step0`` aligned to the
  controller stride and not (lanes admitted in different waves, a wave
  length that is no multiple of the stride): final rows and ``done_at``
  bit for bit.
* The kernel's wave mode: ``csrc/tick_loop.cu`` compiled whole for the host
  (as tests/test_torch_tick_loop_host.py builds it, against
  tests/tick_host/) and launched through the wrapper's own marshalling, a
  wave's groups in one launch, against the plain wave, bit for bit, for
  every controller kind (the learned one too) and environment family
  without jitter; lossy-wan's jitter calls the C library's ``sinf`` here
  against ``torch.sin`` and is held to 1e-5 of each row's largest
  magnitude, with the int rows and ``done_at`` exact (on the card both
  sides call libdevice's ``sinf``: tests/test_torch_fleet_gpu.py holds
  them bit for bit).
"""
import ctypes
import dataclasses
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import fleet as jfleet
from repro.core import engine as jengine
from repro.core.types import CHAMELEON, CLOUDLAB, DatasetSpec
from repro.fleet.admission import Combo as JCombo
from repro_torch import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.fleet.admission import Combo as TCombo
from repro_torch.kernels import build
from repro_torch.kernels import tick_loop as tl
from test_torch_fleet import port_host, port_request

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "src", "repro_torch", "kernels", "csrc")
JITTER_RTOL = 1e-5

FAST = (DatasetSpec("a", 200, 400.0, 2.0),
        DatasetSpec("b", 10, 600.0, 60.0))
ONE = (DatasetSpec("c", 50, 500.0, 10.0),)
BIG = (DatasetSpec("a", 2000, 4000.0, 2.0),
       DatasetSpec("b", 100, 6000.0, 60.0))
MENU = (FAST, ONE, BIG)
DT = 0.5
WAVE = 7            # ticks a wave: no multiple of the stride (2 at dt 0.5)
SHARES = (1.0, 0.7, 0.45)
STEP0 = {"aligned": (0, 0, 0), "unaligned": (0, 3, 5)}


def _controller(name):
    if name in ("eett", "ismail-target"):
        return japi.make_controller(name, target_tput_mbps=400.0)
    if name == "learned":
        from repro import learn as jlearn
        from repro.learn.controller import LearnedController
        return LearnedController(params=jlearn.init_policy(
            jlearn.PolicyConfig(), jax.random.PRNGKey(1)))
    return japi.make_controller(name) if name != "wget/curl" else name


def _combos(ctrl, host, profile=CHAMELEON):
    """JAX's and the port's combos of the menu's datasets on ``host``,
    finalized at the menu's widest partition count."""
    jreqs = [jfleet.TransferRequest(arrival_s=0.0, datasets=ds,
                                    controller=ctrl, profile=profile)
             for ds in MENU]
    js = [JCombo(r, host, DT) for r in jreqs]
    ts = [TCombo(port_request(r), port_host(host), DT) for r in jreqs]
    p = max(c.n_partitions for c in js)
    for c in js + ts:
        c.finalize(p)
    return js, ts


def _rows(combos):
    return (np.stack([c.params_row for c in combos]),
            np.stack([c.f0 for c in combos]),
            np.stack([c.i0 for c in combos]))


HOST_ENVS = {
    "reference": None,
    "big-little": japi.make_environment("big-little", n_big=4),
    "dvfs": japi.make_environment("dvfs", tech="hp", idle="race", n_big=4),
    "lossy-wan-loss": japi.make_environment("lossy-wan", jitter_frac=0.0),
}


@pytest.mark.parametrize("env", sorted(HOST_ENVS))
@pytest.mark.parametrize("ctrl", ["eemt", "wget/curl", "learned"])
def test_combo_rows_equal_jax(ctrl, env):
    host = jfleet.Host("h", environment=HOST_ENVS[env])
    js, ts = _combos(_controller(ctrl), host)
    for j, t in zip(js, ts):
        for f in ("params_row", "f0", "i0"):
            a, b = getattr(j, f), getattr(t, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (j.ctrl_name, j.n_partitions, j.ideal_s) == \
            (t.ctrl_name, t.n_partitions, t.ideal_s)
        assert [dataclasses.astuple(x) for x in j.specs] == \
            [dataclasses.astuple(x) for x in t.specs]
        assert np.array_equal(j.offered_parts, t.offered_parts)
        assert j.key[3] == t.key[3]


def _jax_wave(js, rows, shares, step0, n_waves):
    """JAX's blocked wave core, lane by lane, op by op: the rows after
    each wave and each wave's done_at."""
    code, env_code, cpu, ce = js[0].key
    core = jengine.build_blocked_wave_core(
        code, env_code, cpu, wave_steps=WAVE, dt=DT, ctrl_every=ce,
        n_partitions=js[0].n_partitions)
    prow, f32, i32 = rows
    out = []
    with jax.disable_jit():
        for w in range(n_waves):
            lanes = [core(prow[b], np.float32(shares[b]), f32[b], i32[b],
                          np.int32(step0[b] + w * WAVE))
                     for b in range(len(prow))]
            f32 = np.stack([np.asarray(x[0]) for x in lanes])
            i32 = np.stack([np.asarray(x[1]) for x in lanes])
            out.append((f32, i32, np.asarray([int(x[2]) for x in lanes])))
    return out


@pytest.mark.parametrize("phase", sorted(STEP0))
@pytest.mark.parametrize("ctrl", ["eemt", "me", "wget/curl"])
def test_plain_wave_matches_jax_wave_by_wave(ctrl, phase):
    host = jfleet.Host("h")
    js, ts = _combos(_controller(ctrl), host)
    rows = _rows(js)
    step0 = STEP0[phase]
    want = _jax_wave(js, rows, SHARES, step0, n_waves=4)
    code, env_code, cpu, ce = ts[0].key
    assert ce == 2 or ctrl == "wget/curl"
    runner = tengine.get_wave_runner(code, env_code, cpu, WAVE, DT, ce,
                                     ts[0].n_partitions)
    prow, f32, i32 = (torch.as_tensor(x) for x in _rows(ts))
    bw = torch.tensor(SHARES, dtype=torch.float32)
    for w, (jf, ji, jd) in enumerate(want):
        s0 = torch.tensor(step0, dtype=torch.int32) + w * WAVE
        f32, i32, done_at = runner(prow, bw, f32, i32, s0)
        assert np.array_equal(f32.numpy(), jf), w
        assert np.array_equal(i32.numpy(), ji), w
        assert np.array_equal(done_at.numpy(), jd), w
    assert (want[-1][2] >= 0).any()      # some lane drained in the waves


def test_wave_runner_is_cached_and_checks_its_width():
    from repro_torch.core.types import CpuProfile
    tengine.clear_runner_caches()
    ctrl = tapi.make_controller("eemt").code()
    env = tapi.as_environment(None).code()
    a = tengine.get_wave_runner(ctrl, env, CpuProfile(), WAVE, DT, 2, 2)
    b = tengine.get_wave_runner(ctrl, env, CpuProfile(), WAVE, DT, 2, 2)
    assert a is b and tengine.runner_cache_sizes() == {"runner": 1}
    c = tengine.get_wave_runner(ctrl, env, CpuProfile(), WAVE, DT, 2, 3)
    assert c is not a and tengine.runner_cache_sizes() == {"runner": 2}
    with pytest.raises(ValueError):
        a(torch.zeros((1, 13 + 5 * 3)), torch.ones(1), torch.zeros((1, 15)),
          torch.zeros((1, 3), dtype=torch.int32),
          torch.zeros(1, dtype=torch.int32))
    tengine.clear_runner_caches()


def test_drained_and_zero_lanes_are_frozen():
    """A drained transfer keeps its rows through a wave and reports step0
    as done_at; zero rows (drained filler lanes, which a device split pads
    with) report step0 too and change no other lane.  (A zero row's own
    accumulators go NaN in the plain wave, 0/0 masked by a multiply, as in
    JAX's; the kernel never ticks it.  Its rows are discarded.)"""
    js, ts = _combos(_controller("eemt"), jfleet.Host("h"))
    code, env_code, cpu, ce = ts[0].key
    prow, f32, i32 = (torch.as_tensor(x) for x in _rows(ts))
    runner = tengine.get_wave_runner(code, env_code, cpu, 400, DT, ce,
                                     ts[0].n_partitions)
    bw = torch.ones(3)
    f1, i1, d1 = runner(prow, bw, f32, i32, torch.zeros(3, dtype=torch.int32))
    assert (d1 >= 0).all()
    zero = [torch.zeros_like(x) for x in (prow, f32, i32)]
    f2, i2, d2 = runner(torch.cat([prow, zero[0]]), torch.ones(6),
                        torch.cat([f1, zero[1]]), torch.cat([i1, zero[2]]),
                        torch.full((6,), 9, dtype=torch.int32))
    assert torch.equal(f2[:3], f1) and torch.equal(i2[:3], i1)
    assert (d2 == 9).all()


# ------------------------------------------- the kernel's wave mode --------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
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
    return build.bind_tick_loop(ctypes.CDLL(str(lib)),
                                "host_tick_loop_grouped_launch")


def _host_waves(host_lib, waves):
    err, outs, launches = tl.launch_groups(
        host_lib, host_lib.host_tick_loop_grouped_launch, waves,
        stream=None)
    assert err == 0
    return outs, launches


KERNEL_ENVS = {
    "reference": None,
    "lossy-wan": "lossy-wan",
    "big-little": japi.make_environment("big-little", n_big=4),
    "dvfs-lp-capped": japi.make_environment("dvfs", tech="lp",
                                            max_freq_ghz=1.8),
    "logfit": japi.make_environment("logfit", log=[
        dict(start_s=k * 2.0, end_s=(k + 1) * 2.0, mb=bw * 2.0, rtt_s=0.04)
        for k, bw in enumerate((800.0, 1200.0, 400.0, 1000.0))], bin_s=2.0),
}
KERNEL_CTRLS = ["me", "eemt", "eett", "ismail-target", "wget/curl",
                "learned"]


@pytest.fixture(scope="module")
def wave_groups():
    """One wave batch per (controller, environment): three lanes each."""
    out = {}
    for env in sorted(KERNEL_ENVS):
        for ctrl in KERNEL_CTRLS:
            _, ts = _combos(_controller(ctrl),
                            jfleet.Host("h", environment=KERNEL_ENVS[env]),
                            profile=CLOUDLAB if env == "dvfs-lp-capped"
                            else CHAMELEON)
            out[(env, ctrl)] = ts
    return out


def _assert_rows(env, got, want):
    (kf, ki, kd), (pf, pi, pd) = got, want
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    if env == "lossy-wan":
        scale = pf.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        assert ((kf - pf).abs() <= JITTER_RTOL * scale).all()
    else:
        assert torch.equal(kf, pf)


@pytest.mark.parametrize("phase", sorted(STEP0))
def test_kernel_wave_mode_equals_plain_wave(host_lib, wave_groups, phase):
    """Every (controller, environment) batch of the menu through the
    kernel's wave mode, all 30 groups in one launch a wave, for 6 waves:
    each wave's rows and done_at equal the plain wave's."""
    keys = sorted(wave_groups)
    state = {}
    for k in keys:
        prow, f32, i32 = (torch.as_tensor(x) for x in _rows(wave_groups[k]))
        state[k] = {"prow": prow, "kern": (f32, i32), "plain": (f32, i32)}
    bw = torch.tensor(SHARES, dtype=torch.float32)
    for w in range(6):
        s0 = torch.tensor(STEP0[phase], dtype=torch.int32) + w * WAVE
        waves = []
        for k in keys:
            code, env_code, cpu, ce = wave_groups[k][0].key
            waves.append(tl.Wave(code, env_code, cpu, state[k]["prow"], bw,
                                 *state[k]["kern"], s0, WAVE, DT, ce))
        outs, launches = _host_waves(host_lib, waves)
        assert launches == 1
        for k, wv, out in zip(keys, waves, outs):
            plain = tl.tick_wave_reference(
                wv.controller, wv.env, wv.cpu, wv.prow, bw,
                *state[k]["plain"], s0, wave_steps=WAVE, dt=DT,
                ctrl_every=wv.ctrl_every)
            _assert_rows(k[0], out, plain)
            state[k]["kern"], state[k]["plain"] = out[:2], plain[:2]


def test_kernel_wave_mode_splits_above_60_groups(host_lib, wave_groups):
    """61 groups (the menu's batches, one twice): two launches, each group
    equal to its own plain wave."""
    keys = sorted(wave_groups)
    bw = torch.tensor(SHARES, dtype=torch.float32)
    s0 = torch.tensor(STEP0["unaligned"], dtype=torch.int32)
    waves = []
    for k in (keys * 3)[:61]:
        code, env_code, cpu, ce = wave_groups[k][0].key
        prow, f32, i32 = (torch.as_tensor(x) for x in _rows(wave_groups[k]))
        waves.append(tl.Wave(code, env_code, cpu, prow, bw, f32, i32, s0,
                             WAVE, DT, ce))
    outs, launches = _host_waves(host_lib, waves)
    assert launches == 2
    for k, wv, out in zip((keys * 3)[:61], waves, outs):
        plain = tl.tick_wave_reference(
            wv.controller, wv.env, wv.cpu, wv.prow, bw, wv.f32, wv.i32, s0,
            wave_steps=WAVE, dt=DT, ctrl_every=wv.ctrl_every)
        _assert_rows(k[0], out, plain)


def test_fleet_through_the_kernel_wave_mode(host_lib, monkeypatch):
    """``run_fleet``'s cuda path on the CPU: the host build stands in for
    the card's launches (one a wave), and the report equals the plain
    fleet's bit for bit on tests/test_fleet.py's golden trace."""
    from repro_torch import fleet as tfleet
    from test_torch_fleet import assert_equal, golden_trace
    calls = []

    def on_host(waves):
        outs, launches = _host_waves(host_lib, waves)
        calls.append(launches)
        return outs

    trace = [port_request(r) for r in golden_trace()]
    hosts = tfleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    plain = tfleet.run_fleet(trace, hosts, wave_s=10.0, dt=DT,
                             devices=["cpu"])
    monkeypatch.setattr(tengine, "run_cuda_wave_groups", on_host)
    monkeypatch.setattr(tengine, "resolve_executor",
                        lambda executor, device=None, **kw: "cuda")
    kern = tfleet.run_fleet(trace, hosts, wave_s=10.0, dt=DT,
                            devices=["cpu"])
    assert_equal(plain, kern)
    assert calls == [1] * kern.waves


def test_wave_batches_are_checked():
    """The card's checks on a wave batch (run before any launch): the
    partition limit, the [B] share and start ticks."""
    _, ts = _combos(_controller("eemt"), jfleet.Host("h"))
    code, env_code, cpu, ce = ts[0].key
    prow, f32, i32 = (torch.as_tensor(x) for x in _rows(ts))
    s0 = torch.zeros(3, dtype=torch.int32)
    ok = tl.Wave(code, env_code, cpu, prow, torch.ones(3), f32, i32, s0,
                 WAVE, DT, ce)
    tl._check_batches([ok], torch.device("cpu"))
    with pytest.raises(ValueError):
        tl._check_batches([ok._replace(bw=torch.ones((3, WAVE)))],
                          torch.device("cpu"))
    with pytest.raises(ValueError):
        tl._check_batches([ok._replace(step0=s0.long())],
                          torch.device("cpu"))
    wide = 13 + 5 * 9
    with pytest.raises(ValueError, match="partitions"):
        tl._check_batches([ok._replace(prow=torch.zeros((3, wide)))],
                          torch.device("cpu"))
