"""The tick-loop kernel module: its plain version against the JAX package's
fused tick-loop kernel (``_build_pallas_core``), the wrapper's dispatch
rules (the CUDA kernel against the plain version on a card:
tests/test_torch_gpu.py).

Two JAX oracles, on the packed rows of the four GOLDEN_SUBSET scenarios of
tests/test_executors.py:

* the Pallas kernel's own loop (engine.py:575-593: ``make_step_fn`` ticks
  while the transfer is live, traces pre-filled) run op by op under
  ``jax.disable_jit()`` — final rows and all seven traces bit-exact;
* ``_build_pallas_core`` itself in interpret mode (``executor="pallas"``,
  as tests/test_executors.py runs it).  Interpret mode hands the kernel body
  to XLA, whose fused float32 arithmetic differs from JAX's op-by-op
  semantics by up to 2.6e-7 relative on these cells (ROADMAP, queue 3):
  discrete fields are held exactly, float fields to rtol 1e-6.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import scenario as jscenario
from repro.core import engine as jengine
from repro.core import tickstate as jts
from repro.core import types as jtypes
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import environments as tenv
from repro_torch.core import engine as tengine
from repro_torch.core import types as ttypes
from repro_torch.kernels import build
from repro_torch.kernels import tick_loop as tl
from torch_parity import jax_kernel_loop_op_by_op

# tests/test_executors.py GOLDEN_SUBSET
CELLS = [("chameleon", "eemt", "fast"), ("chameleon", "me", "fast"),
         ("chameleon", "wget/curl", "one"), ("cloudlab", "eett", "one")]
DATASETS = {"fast": (("a", 200, 400.0, 2.0), ("b", 10, 600.0, 60.0)),
            "one": (("c", 50, 500.0, 10.0),)}


def _controller(api, name):
    kw = {"target_tput_mbps": 400.0} if name == "eett" else {}
    return api.make_controller(name, **kw)


def _jax_prepared(cell):
    pn, cn, dn = cell
    sc = japi.Scenario(
        profile=jtypes.TESTBEDS[pn],
        datasets=tuple(jtypes.DatasetSpec(*d) for d in DATASETS[dn]),
        controller=_controller(japi, cn), total_s=240.0, dt=0.1)
    return jscenario._prepare(sc)


def _port_call(cell, prep, device="cpu"):
    """(port controller code, kwargs, rows) for one lane from JAX inputs."""
    inp = convert.to_torch(jax.tree.map(lambda x: np.asarray(x)[None],
                                        prep.inputs), device)
    prow, f0, i0 = tengine.pack_batch(tenv.REFERENCE_ENV, inp)
    ctrl = tapi.as_controller(_controller(tapi, cell[1])).code()
    k = prep.key
    args = (ctrl, tenv.REFERENCE_ENV, ttypes.CpuProfile(), prow, inp.bw, f0,
            i0)
    return args, dict(dt=k.dt, ctrl_every=k.ctrl_every)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_plain_version_bit_exact_vs_jax_kernel_loop(cell):
    prep = _jax_prepared(cell)
    want_f, want_i, want_tr = jax_kernel_loop_op_by_op(prep)
    args, kw = _port_call(cell, prep)
    f32, i32, m = tl.tick_loop_reference(*args, **kw)
    np.testing.assert_array_equal(f32[0].numpy(), want_f)
    np.testing.assert_array_equal(i32[0].numpy(), want_i)
    for field, got, want in zip(ttypes.TickMetrics._fields, m, want_tr):
        assert got.dtype == torch.from_numpy(want).dtype, field
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=field)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_plain_version_vs_jax_pallas_interpret(cell):
    prep = _jax_prepared(cell)
    k = prep.key
    runner = jengine.get_runner(k.ctrl_code, k.env_code, k.cpu, k.n_steps,
                                k.dt, k.ctrl_every, batched=False,
                                executor="pallas")
    sim, ts, jm = runner(prep.inputs)
    want_f, want_i = jts.TickLayout(k.n_partitions).pack_state(sim, ts,
                                                               xp=np)
    args, kw = _port_call(cell, prep)
    f32, i32, m = tl.tick_loop_reference(*args, **kw)
    np.testing.assert_array_equal(i32[0].numpy(), np.asarray(want_i))
    np.testing.assert_allclose(f32[0].numpy(), np.asarray(want_f),
                               rtol=1e-6, atol=0)
    for field, got, want in zip(ttypes.TickMetrics._fields, m, jm):
        got, want = got[0].numpy(), np.asarray(want)
        if field in ("cores", "freq_ghz", "done"):
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=field)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=field)


def test_cpu_tensors_take_the_plain_version():
    prep = _jax_prepared(CELLS[1])
    args, kw = _port_call(CELLS[1], prep)
    before = tl.tick_loop.launches
    a = tl.tick_loop(*args, **kw)
    b = tl.tick_loop_reference(*args, **kw)
    assert tl.tick_loop.launches == before      # nothing was launched
    for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert torch.equal(x, y)
    # the traces are [B, n_steps] views of time-major buffers
    assert a[2].tput_mbps.shape == (1, prep.key.n_steps)
    assert a[2].tput_mbps.t().is_contiguous()


def test_kernel_spec_covers_the_builtin_controllers():
    ref = tenv.REFERENCE_ENV
    spec = {name: tl.kernel_spec(tapi.make_controller(name).code(), ref)[:2]
            for name in ("ME", "EEMT", "EETT", "ismail-target", "wget/curl",
                         "ismail-max-tput")}
    assert spec == {"ME": (tl.KIND_ME, True), "EEMT": (tl.KIND_EEMT, True),
                    "EETT": (tl.KIND_EETT, True),
                    "ismail-target": (tl.KIND_ISMAIL, False),
                    "wget/curl": (tl.KIND_STATIC, False),
                    "ismail-max-tput": (tl.KIND_STATIC, False)}
    assert tl.kernel_spec(
        tapi.make_controller("EEMT", scaling=False).code(), ref)[:2] == (
        tl.KIND_EEMT, False)
    assert tl.kernel_spec(tapi.make_controller("EEMT"), ref)[2].reference
    learned = tapi.make_controller("learned", max_ch=64, label="bc")
    assert tl.kernel_spec(learned.code(), ref)[:2] == (tl.KIND_LEARNED,
                                                       False)
    assert tl.kernel_spec(learned.code(), tapi.make_environment(
        "dvfs"))[2].energy == tl.ENERGY_DVFS
    # the weight table: w0 row-major, b0, w1, b1, w2, b2 as float32
    table = learned.code().table("cpu")
    assert tl.policy_widths(learned) == (9, 32, 32, 9)
    assert table.dtype == torch.float32 and table.numel() == (
        9 * 32 + 32 + 32 * 32 + 32 + 32 * 9 + 9)
    assert torch.equal(table[:9 * 32],
                       torch.as_tensor(learned.params["w0"]).reshape(-1))
    assert torch.equal(table[-9:], torch.as_tensor(learned.params["b2"]))
    assert learned.code().table("cpu") is table   # uploaded once


def _codes(spec):
    return dict(zip(tl.ENV_CODES, spec.codes))


def _consts(spec):
    return dict(zip(tl.ENV_CONSTS, spec.consts.tolist()))


def test_kernel_spec_covers_every_environment_pairing():
    """Every network model x energy model the registries build (and every
    registered environment) has kernel codes; the dvfs network is the
    reference wire physics."""
    ctrl = tapi.make_controller("EEMT")
    net_code = {"reference": tl.NET_REFERENCE, "dvfs": tl.NET_REFERENCE,
                "lossy-wan": tl.NET_LOSSY_WAN, "logfit": tl.NET_LOGFIT}
    energy_code = {"reference": tl.ENERGY_REFERENCE,
                   "big-little": tl.ENERGY_BIG_LITTLE,
                   "dvfs": tl.ENERGY_DVFS}
    networks = [tapi.make_network_model(n) for n in net_code
                if n != "logfit"]
    networks.append(tapi.make_environment("logfit").network)
    for net in networks:
        for en in tapi.list_energy_models():
            env = tenv.Environment(network=net,
                                   energy=tapi.make_energy_model(en))
            spec = tl.kernel_spec(ctrl, env)[2]
            assert (spec.network, spec.energy) == (net_code[net.name],
                                                   energy_code[en])
            assert spec.reference == (spec.network == spec.energy == 0)
    for name in tapi.list_environments():
        tl.kernel_spec(ctrl, tapi.make_environment(name))
    for obj in (tapi.LossyWanNetworkModel(), tapi.BigLittleEnergyModel(),
                tapi.DvfsEnergyModel.for_tech("lp")):
        tl.kernel_spec(ctrl, tapi.as_environment(obj))


def test_kernel_spec_constants_are_float32_of_the_python_expressions():
    ctrl = tapi.make_controller("ME")
    lossy = tl.kernel_spec(ctrl, tapi.make_environment(
        "lossy-wan", loss_rate=1e-3, jitter_frac=0.2,
        jitter_period_s=30.0))[2]
    c = _consts(lossy)
    assert _codes(lossy)["loss"] == _codes(lossy)["jitter"] == 1
    assert c["w_loss"] == np.float32(1.22 * (1500.0 / (1024.0 * 1024.0))
                                     / math.sqrt(1e-3))
    assert c["knee_div"] == np.float32(1.0 + 4.0 * math.sqrt(1e-3))
    assert c["jitter_rate"] == np.float32(2.0 * math.pi / 30.0)
    assert c["jitter_frac"] == np.float32(0.2)
    clean = tl.kernel_spec(ctrl, tapi.make_environment(
        "lossy-wan", loss_rate=0.0, jitter_frac=0.0))[2]
    assert _codes(clean)["loss"] == _codes(clean)["jitter"] == 0

    dvfs = tl.kernel_spec(ctrl, tapi.make_environment(
        "dvfs", tech="lp", idle="race", n_big=3, max_freq_ghz=1.8))[2]
    c, k = _consts(dvfs), _codes(dvfs)
    assert (k["race"], k["capped"], k["n_vf"]) == (1, 1, 7)
    lp = tapi.DvfsEnergyModel.for_tech("lp")
    assert c["max_freq"] == np.float32(1.8) and c["n_big"] == 3.0
    assert c["little_dyn"] == np.float32(lp.little_cap_frac)
    assert c["little_static"] == np.float32(lp.little_leak_frac)
    n = len(tl.ENV_CONSTS)
    np.testing.assert_array_equal(
        dvfs.consts[n:n + 7], np.asarray(lp.vf_ghz, np.float32))
    np.testing.assert_array_equal(
        dvfs.consts[n + tl.MAX_VF_POINTS:n + tl.MAX_VF_POINTS + 7],
        np.asarray(lp.vf_volt, np.float32))
    assert dvfs.consts.dtype == np.float32
    assert dvfs.consts.size == n + 2 * tl.MAX_VF_POINTS

    fit = tl.kernel_spec(ctrl, tapi.make_environment("logfit", log=[
        dict(start_s=0.0, end_s=60.0, mb=6e4, rtt_s=0.04)]))[2]
    assert _codes(fit)["fit_rtt"] == 1 and _codes(fit)["n_bins"] == 1
    assert _consts(fit)["rtt_fit"] == np.float32(0.04)
    assert fit.schedule == (1000.0,)


def test_kernel_spec_rejects_what_the_kernel_does_not_implement():
    class Slower(tenv.ReferenceNetworkModel):
        name = "slower"

    with pytest.raises(ValueError, match="reference environment"):
        tl.kernel_spec(tapi.make_controller("EEMT"),
                       tenv.Environment(network=Slower()))

    class Hotter(tapi.DvfsEnergyModel):
        pass

    with pytest.raises(ValueError, match="no code for energy model Hotter"):
        tl.kernel_spec(tapi.make_controller("EEMT"),
                       tenv.Environment(energy=Hotter()))
    long_table = tapi.DvfsEnergyModel(
        vf_ghz=tuple(0.5 + 0.1 * i for i in range(17)),
        vf_volt=tuple(0.6 + 0.05 * i for i in range(17)))
    with pytest.raises(ValueError, match="at most 16 points"):
        tl.kernel_spec(tapi.make_controller("EEMT"),
                       tenv.Environment(energy=long_table))

    class Custom(tapi.TunerController):
        pass

    with pytest.raises(ValueError, match="no code for controller"):
        tl.kernel_spec(Custom(), tenv.REFERENCE_ENV)

    from repro_torch.learn import LearnedController, PolicyConfig

    for hidden, match in (((32, 32, 32, 32), "at most 4 layers"),
                          ((65,), "at most 64 wide"),
                          ((32, 128), "at most 64 wide")):
        deep = LearnedController(cfg=PolicyConfig(hidden=hidden))
        with pytest.raises(ValueError, match=match):
            tl.kernel_spec(deep, tenv.REFERENCE_ENV)
    wide_in = LearnedController(cfg=PolicyConfig(obs_dim=10))
    with pytest.raises(ValueError, match="9 features"):
        tl.kernel_spec(wide_in, tenv.REFERENCE_ENV)
    tl.kernel_spec(LearnedController(cfg=PolicyConfig(hidden=(64, 64, 64))),
                   tenv.REFERENCE_ENV)
    tl.kernel_spec(LearnedController(cfg=PolicyConfig(hidden=())),
                   tenv.REFERENCE_ENV)

    class SubLearned(LearnedController):
        pass

    with pytest.raises(ValueError, match="no code for controller"):
        tl.kernel_spec(SubLearned(), tenv.REFERENCE_ENV)


def test_wrapper_rejects_other_devices():
    prep = _jax_prepared(CELLS[0])
    args, kw = _port_call(CELLS[0], prep, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tl.tick_loop(*args, **kw)


def test_ptxas_report_parsing():
    name3 = "_ZN4tick24tick_loop_grouped_kernelILi3EEEvNS_10GroupTableE"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name3}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name3}",
        "    544 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 236 registers, used 1 barriers, "
        "31216 bytes cmem[0]",
    ])
    report = build.ptxas_report(log)
    (name, line), = report.items()
    assert build.tick_loop_grouped_instance(name) == 3
    assert "236 registers" in line and "0 bytes spill stores" in line
    assert build.tick_loop_grouped_instance(
        "_ZN4tick24tick_loop_grouped_kernelILi8EEEvNS_10GroupTableE") == 8
    assert build.tick_loop_grouped_instance(
        "_ZN5rglru12rglru_kernelIfLi32EEEv") is None


def test_build_flags_pin_the_numerics():
    assert "-fmad=false" in build.NVCC_FLAGS and "-ftz=true" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
