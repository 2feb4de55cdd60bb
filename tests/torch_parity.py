"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py):
JAX-side oracles and converters between the two packages' scenarios.  Data
crosses between the packages as numpy; JAX stays on the CPU."""
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from repro import api as japi
from repro.core import engine as jengine
from repro.core import tickstate as jts
from repro_torch import api as tapi
from repro_torch.core import types as ttypes
from repro_torch.workloads.logfit import LogFitNetworkModel


def port_profile(p):
    return ttypes.NetworkProfile(*dataclasses.astuple(p))


def port_datasets(ds):
    return tuple(ttypes.DatasetSpec(*dataclasses.astuple(d)) for d in ds)


def port_cpu(cpu):
    return ttypes.CpuProfile(*dataclasses.astuple(cpu))


# The port's model class for each JAX model name, by protocol half.
_NETWORKS = {"reference": tapi.ReferenceNetworkModel,
             "lossy-wan": tapi.LossyWanNetworkModel,
             "dvfs": tapi.DvfsNetworkModel,
             "logfit": LogFitNetworkModel}
_ENERGIES = {"reference": tapi.ReferenceEnergyModel,
             "big-little": tapi.BigLittleEnergyModel,
             "dvfs": tapi.DvfsEnergyModel}


def port_environment(env):
    """The port's Environment for a JAX Environment (or anything the JAX
    ``as_environment`` takes), model by model: the class by the model's
    name, the fields by the dataclass's."""
    env = japi.as_environment(env)

    def port(model, classes):
        return classes[model.name](**{
            f.name: getattr(model, f.name)
            for f in dataclasses.fields(model)})

    return tapi.Environment(network=port(env.network, _NETWORKS),
                            energy=port(env.energy, _ENERGIES))


def port_scenario(sc, **overrides):
    """The port's Scenario for a JAX Scenario with a registry-name or
    built-in controller (any environment and CPU)."""
    ctrl = sc.controller
    if type(ctrl).__name__ == "LearnedController":
        from repro_torch.learn import LearnedController, PolicyConfig
        ctrl = LearnedController(
            params=ctrl.params,
            cfg=PolicyConfig(*dataclasses.astuple(ctrl.cfg)),
            sla=ttypes.SLA(*dataclasses.astuple(ctrl.sla)), label=ctrl.label)
    elif type(ctrl).__name__ == "StaticBaselineController":
        ctrl = tapi.StaticBaselineController(label=ctrl.label,
                                             builder=ctrl.builder,
                                             params=ctrl.params)
    elif type(ctrl).__name__ == "IsmailTargetController":
        ctrl = tapi.IsmailTargetController(
            sla=ttypes.SLA(*dataclasses.astuple(ctrl.sla)), label=ctrl.label)
    elif not isinstance(ctrl, str):
        sla = ttypes.SLA(*dataclasses.astuple(ctrl.sla))
        ctrl = tapi.TunerController(sla=sla, scaling=ctrl.scaling,
                                    label=ctrl.label)
    assert sc.bw_schedule is None
    kw = dict(profile=port_profile(sc.profile),
              datasets=port_datasets(sc.datasets), controller=ctrl,
              cpu=port_cpu(sc.cpu),
              environment=port_environment(sc.environment),
              total_s=sc.total_s, dt=sc.dt, name=sc.name)
    kw.update(overrides)
    return tapi.Scenario(**kw)


def jax_kernel_loop_op_by_op(prep):
    """The loop of the JAX package's fused tick kernel (engine.py:575-593:
    ``make_step_fn`` ticks while the transfer is live, traces pre-filled
    with the never-executed values), one JAX op at a time under
    ``jax.disable_jit()``.  Returns the final (f32, i32) rows and the seven
    [n_steps] traces, as numpy."""
    k, inp = prep.key, prep.inputs
    lay = jts.TickLayout(k.n_partitions)
    n = k.n_steps
    with jax.disable_jit():
        carry = (k.env_code.network.init_state(inp.total_mb, inp.net),
                 jax.tree.map(jnp.asarray, inp.state0))
        step = jengine.make_step_fn(k.ctrl_code, k.env_code, k.cpu, inp,
                                    dt=k.dt, ctrl_every=k.ctrl_every)
        traces = [np.zeros(n, np.float32) for _ in range(4)] + [
            np.zeros(n, np.int32), np.zeros(n, np.float32),
            np.ones(n, np.int32)]
        i = 0
        while i < n and float(jnp.sum(carry[0].remaining_mb)) > 0.0:
            carry, m = step(carry, (jnp.int32(i), inp.bw[i]))
            for buf, v in zip(traces, m):
                buf[i] = np.asarray(v)
            i += 1
        f32, i32 = lay.pack_state(*carry, xp=np)
    return np.asarray(f32), np.asarray(i32), traces


def jax_observed_op_by_op(prep):
    """The JAX package's observed step (``make_step_fn(observe=True)``) op
    by op under ``jax.disable_jit()``, ticking while the transfer is live;
    ticks never executed hold the all-zero observation.  Returns the
    ``Observation`` fields as [n_steps] numpy arrays."""
    k, inp = prep.key, prep.inputs
    n = k.n_steps
    obs = jengine._init_obs_buffer(n)
    out = [np.array(x) for x in obs]
    with jax.disable_jit():
        carry = (k.env_code.network.init_state(inp.total_mb, inp.net),
                 jax.tree.map(jnp.asarray, inp.state0))
        step = jengine.make_step_fn(k.ctrl_code, k.env_code, k.cpu, inp,
                                    dt=k.dt, ctrl_every=k.ctrl_every,
                                    observe=True)
        i = 0
        while i < n and float(jnp.sum(carry[0].remaining_mb)) > 0.0:
            carry, (_, o) = step(carry, (jnp.int32(i), inp.bw[i]))
            for buf, v in zip(out, o):
                buf[i] = np.asarray(v)
            i += 1
    return jengine.Observation(*out)


def summary(f32, done, prep):
    """(completed, time_s, energy_j, avg_tput_MBps, avg_power_w) from a
    final f32 row and the done trace, as ``api.run`` post-processes them."""
    lay = jts.TickLayout(prep.key.n_partitions)
    completed = bool(np.sum(f32[:lay.n_partitions]) <= 0.0)
    t = (float(prep.dt * (int(np.argmax(done)) + 1)) if completed
         else float(prep.total_s))
    energy = float(f32[lay.off_energy])
    moved = float(f32[lay.off_bytes])
    return (completed, t, energy, moved / max(t, 1e-9),
            energy / max(t, 1e-9))


def build_rglru_host(tmp_dir):
    """``csrc/rglru.cu``'s kernels built by g++ for the host
    (tests/tick_host/rglru_harness.cpp on the sm90 emulator, tests/sm90):
    the ``rglru_host`` function of the library, or None without g++."""
    from repro_torch.kernels import build

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = (build.CSRC / "rglru.cu").read_text()
    src = src[:src.index("template <typename T>\nint launch(")]
    src = re.sub(r'#include [<"].*[>"]\n', "", src)
    src = src.replace("extern __shared__ uint8_t smem_raw[];",
                      "using ::smem_raw;")
    (tmp_dir / "rglru_cut.inc").write_text(f"namespace rg {{\n{src}\n}}}}\n")
    lib = tmp_dir / "rglru_host.so"
    # Hidden, non-unique symbols: the emulator's inline globals
    # (threadIdx, ...) must not bind to those of another host build loaded
    # in the same process (tests/tick_host/harness.cpp's).
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-fvisibility=hidden",
                    "-fno-gnu-unique", "-shared", "-fPIC", "-pthread",
                    f"-I{here}/sm90", f"-I{build.CSRC}", f"-I{tmp_dir}",
                    "-o", str(lib), f"{here}/tick_host/rglru_harness.cpp"],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).rglru_host
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def rglru_host_call(fn, mode, xs, outs, width=32):
    """Run the host build: mode 0 the forward's direct path, 2 its TMA
    ring (``xs`` = a, b; ``outs`` = h), 1 the backward's direct path, 3 its
    TMA ring (``xs`` = a, h, g; ``outs`` = da, db); ``width`` the block's
    channels."""
    B, T, C = xs[0].shape
    dtype = 0 if xs[0].dtype.itemsize == 4 else 1
    st = [x.stride(i) for x in (*xs, *outs) for i in (0, 1)]
    ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
    err = fn(mode, dtype, *ptrs, outs[0].data_ptr(),
             outs[1].data_ptr() if len(outs) > 1 else None, B, T, C,
             (ctypes.c_longlong * len(st))(*st), width)
    assert err == 0


def build_wkv_host(tmp_dir):
    """``csrc/wkv.cu``'s kernels built by g++ for the host
    (tests/sm90/wkv_harness.cpp on the sm90 emulator): the ``wkv_host``
    function of the library (``wkv_launch``'s arguments without the
    stream), or None without g++."""
    from repro_torch.kernels import build

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = (build.CSRC / "wkv.cu").read_text()
    src = src[:src.index("template <typename T, typename TW>\nint launch(")]
    src = re.sub(r'#include [<"].*[>"]\n', "", src)
    src = src.replace("extern __shared__ uint8_t smem_raw[];",
                      "using ::smem_raw;")
    (tmp_dir / "wkv_cut.inc").write_text(f"namespace wk {{\n{src}\n}}}}\n")
    lib = tmp_dir / "wkv_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-fvisibility=hidden", "-fno-gnu-unique", "-shared",
                    "-fPIC", "-pthread", f"-I{here}/sm90", f"-I{build.CSRC}",
                    f"-I{tmp_dir}", "-o", str(lib),
                    f"{here}/sm90/wkv_harness.cpp"],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).wkv_host
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 2)
    fn.restype = ctypes.c_int
    return fn


def wkv_host_call(fn, r, k, v, w, u, S0, route, nj=64):
    """(y, S_final) of the host build on [B, H, T, 64] views: route 0 the
    step kernel, 1 the chunked kernel over ``nj`` columns a block."""
    import torch

    B, H, T, _ = r.shape
    y = torch.full(r.shape, float("nan"), dtype=r.dtype).transpose(1, 2) \
        .contiguous().transpose(1, 2)
    S = torch.full((B, H, 64, 64), float("nan"))
    u = u.float().contiguous()
    S0 = None if S0 is None else S0.float().contiguous()
    st = [x.stride(i) for x in (r, k, v, w, y) for i in (0, 1, 2)]
    code = {torch.float32: 0, torch.bfloat16: 1}
    err = fn(code[r.dtype], code[w.dtype], r.data_ptr(), k.data_ptr(),
             v.data_ptr(), w.data_ptr(), u.data_ptr(),
             None if S0 is None else S0.data_ptr(), y.data_ptr(),
             S.data_ptr(), B, H, T, (ctypes.c_longlong * 15)(*st), route, nj)
    assert err == 0
    return y, S


def build_wkv_bwd_host(tmp_dir):
    """``csrc/wkv_bwd.cu``'s kernel built by g++ for the host
    (tests/sm90/wkv_bwd_harness.cpp on the sm90 emulator): the
    ``wkv_bwd_host`` function of the library (``wkv_bwd_launch``'s
    arguments without the stream), or None without g++."""
    from repro_torch.kernels import build

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = (build.CSRC / "wkv_bwd.cu").read_text()
    src = src[:src.index("template <typename T, typename TW>\nint launch(")]
    src = re.sub(r'#include [<"].*[>"]\n', "", src)
    src = src.replace("extern __shared__ uint8_t smem_raw[];",
                      "using ::smem_raw;")
    (tmp_dir / "wkv_bwd_cut.inc").write_text(
        f"namespace wb {{\n{src}\n}}}}\n")
    lib = tmp_dir / "wkv_bwd_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-fvisibility=hidden", "-fno-gnu-unique", "-shared",
                    "-fPIC", "-pthread", f"-I{here}/sm90", f"-I{build.CSRC}",
                    f"-I{tmp_dir}", "-o", str(lib),
                    f"{here}/sm90/wkv_bwd_harness.cpp"],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).wkv_bwd_host
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_longlong)])
    fn.restype = ctypes.c_int
    return fn


def wkv_bwd_host_call(fn, r, k, v, w, u, S0, dy, dS_final):
    """(dr, dk, dv, dw, du [H, 64], dS0) of the host build on [B, H, T, 64]
    views, the gradients allocated with r's (and w's) strides and filled
    with NaN first, du's per-row partials summed over B as the wrapper
    sums them."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6 as wrapper

    B, H, T, _ = r.shape

    def nan_like(x):
        return torch.full_like(x, float("nan"))

    dr, dk, dv, dw = (nan_like(x) for x in (r, k, v, w))
    du = torch.full((B, H, 64), float("nan"))
    dS0 = torch.full((B, H, 64, 64), float("nan"))
    ckpt, sub = (torch.full((n,), float("nan"))
                 for n in wrapper.wkv_bwd_scratch_floats(B, H, T))
    u = u.float().contiguous()
    S0, dS_final = (None if x is None else x.float().contiguous()
                    for x in (S0, dS_final))
    st = [x.stride(i) for x in (r, k, v, w, dy, dr, dk, dv, dw)
          for i in (0, 1, 2)]
    code = {torch.float32: 0, torch.bfloat16: 1}

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = fn(code[r.dtype], code[w.dtype], *[ptr(x) for x in (
        r, k, v, w, dy, u, S0, dS_final, dr, dk, dv, dw, du, dS0, ckpt,
        sub)], B, H, T, (ctypes.c_longlong * 27)(*st))
    assert err == 0
    return dr, dk, dv, dw, du.sum(0), dS0
