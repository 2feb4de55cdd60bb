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
    """``csrc/wkv_bwd.cu``'s kernel (the step route) and
    ``csrc/wkv_bwd_chunk.cu``'s two (the chunked route) built by g++ for
    the host (tests/sm90/wkv_bwd_harness.cpp on the sm90 emulator): the
    library, whose ``wkv_bwd_host`` and ``wkv_bwd_chunk_host`` take
    ``wkv_bwd_launch``'s and ``wkv_bwd_chunk_launch``'s arguments without
    the stream, or None without g++."""
    from repro_torch.kernels import build

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    for source, cut, ns in (
            ("wkv_bwd.cu", "template <typename T, typename TW>\nint launch(",
             "wb"),
            ("wkv_bwd_chunk.cu",
             "template <typename TW, int NJ>\nint launch_state(", "wc")):
        src = (build.CSRC / source).read_text()
        src = src[:src.index(cut)]
        src = re.sub(r'#include [<"].*[>"]\n', "", src)
        src = src.replace("extern __shared__ uint8_t smem_raw[];",
                          "using ::smem_raw;")
        (tmp_dir / f"{source[:-3]}_cut.inc").write_text(
            f"namespace {ns} {{\n{src}\n}}}}\n")
    lib = tmp_dir / "wkv_bwd_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-fvisibility=hidden", "-fno-gnu-unique", "-shared",
                    "-fPIC", "-pthread", f"-I{here}/sm90", f"-I{build.CSRC}",
                    f"-I{tmp_dir}", "-o", str(lib),
                    f"{here}/sm90/wkv_bwd_harness.cpp"],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib))
    lib.wkv_bwd_host.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 16
                                 + [ctypes.c_int] * 3
                                 + [ctypes.POINTER(ctypes.c_longlong)])
    lib.wkv_bwd_host.restype = ctypes.c_int
    lib.wkv_bwd_chunk_host.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int])
    lib.wkv_bwd_chunk_host.restype = ctypes.c_int
    return lib


def _bwd_outputs(r, k, v, w, u, S0, dS_final):
    """NaN-filled gradients with r's (and w's) strides, and u, S0,
    dS_final as the kernels take them."""
    import torch

    B, H = r.shape[:2]

    def nan_like(x):
        return torch.full_like(x, float("nan"))

    outs = [nan_like(x) for x in (r, k, v, w)]
    dS0 = torch.full((B, H, 64, 64), float("nan"))
    S0, dS_final = (None if x is None else x.float().contiguous()
                    for x in (S0, dS_final))
    return outs, dS0, u.float().contiguous(), S0, dS_final


def _ptr(x):
    return None if x is None else x.data_ptr()


def wkv_bwd_host_call(lib, r, k, v, w, u, S0, dy, dS_final):
    """(dr, dk, dv, dw, du [H, 64], dS0) of the host build's step route on
    [B, H, T, 64] views, the gradients allocated with r's (and w's) strides
    and filled with NaN first, du's per-row partials summed over B as the
    wrapper sums them."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6 as wrapper

    B, H, T, _ = r.shape
    (dr, dk, dv, dw), dS0, u, S0, dS_final = _bwd_outputs(
        r, k, v, w, u, S0, dS_final)
    du = torch.full((B, H, 64), float("nan"))
    ckpt, sub = (torch.full((n,), float("nan"))
                 for n in wrapper.wkv_bwd_scratch_floats(B, H, T))
    st = [x.stride(i) for x in (r, k, v, w, dy, dr, dk, dv, dw)
          for i in (0, 1, 2)]
    code = {torch.float32: 0, torch.bfloat16: 1}
    err = lib.wkv_bwd_host(code[r.dtype], code[w.dtype], *[_ptr(x) for x in (
        r, k, v, w, dy, u, S0, dS_final, dr, dk, dv, dw, du, dS0, ckpt,
        sub)], B, H, T, (ctypes.c_longlong * 27)(*st))
    assert err == 0
    return dr, dk, dv, dw, du.sum(0), dS0


def wkv_bwd_chunk_host_call(lib, r, k, v, w, u, S0, dy, dS_final, nj=32):
    """As :func:`wkv_bwd_host_call`, on the host build's chunked route
    (bf16 r, k, v, dy; the state pass over ``nj`` columns a block), du's
    per-(row, chunk) partials summed as the wrapper sums them."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6 as wrapper

    B, H, T, _ = r.shape
    (dr, dk, dv, dw), dS0, u, S0, dS_final = _bwd_outputs(
        r, k, v, w, u, S0, dS_final)
    n_state, n_du = wrapper.wkv_bwd_chunk_scratch_floats(B, H, T)
    sc, dse = (torch.full((n_state,), float("nan")) for _ in range(2))
    du = torch.full((n_du,), float("nan"))
    st = [x.stride(i) for x in (r, k, v, w, dy, dr, dk, dv, dw)
          for i in (0, 1, 2)]
    err = lib.wkv_bwd_chunk_host(
        {torch.float32: 0, torch.bfloat16: 1}[w.dtype], *[_ptr(x) for x in (
            r, k, v, w, dy, u, S0, dS_final, dr, dk, dv, dw, du, dS0, sc,
            dse)], B, H, T, (ctypes.c_longlong * 27)(*st), nj)
    assert err == 0
    return dr, dk, dv, dw, du.view(B, H, -1, 64).sum((0, 2)), dS0


def wkv_bwd_chunked_f64(r, k, v, w, u, S0, dy, dS_final):
    """The WKV backward in float64 by the chunked algebra of
    ``csrc/wkv_bwd_chunk.cu`` (test-only, never on a main path): a state
    pass (S at each 64-step chunk's start, the state gradient dS_e after
    each chunk), then per chunk the gradients from S_c and dS_e, cut into
    16-step sub-chunks as the kernel cuts them (E, F the decay products
    within a sub-chunk before and after a step, GP(a, b) those of whole
    sub-chunks a .. b-1; no ratio of decays anywhere).  [B, H, T, 64]
    inputs of any float type -> (dr, dk, dv, dw [B, H, T, 64], du [H, 64],
    dS0 [B, H, 64, 64]), float64."""
    import torch

    L, SB, f64 = 64, 16, torch.float64
    B, H, T, D = r.shape
    nc = -(-T // L)
    pad = nc * L - T

    def padded(x, fill):
        x = x.to(f64)
        return torch.cat([x, torch.full((B, H, pad, D), fill, dtype=f64)],
                         2) if pad else x

    rr, kk, vv, gg = (padded(x, 0.0) for x in (r, k, v, dy))
    ww = padded(w, 1.0)
    uu = u.to(f64)
    zero = torch.zeros((B, H, D, D), dtype=f64)
    S = zero if S0 is None else S0.to(f64)
    dS = zero if dS_final is None else dS_final.to(f64)

    def decays(wc):
        """E [.., 64, D], F [.., 64, D], G [.., 4, D] and GP(a, b) of one
        chunk's decays wc [.., 64, D]."""
        E, F = torch.ones_like(wc), torch.ones_like(wc)
        G = []
        for d in range(4):
            for t in range(1, SB):
                E[..., d * SB + t, :] = E[..., d * SB + t - 1, :] * \
                    wc[..., d * SB + t - 1, :]
            for t in range(SB - 2, -1, -1):
                F[..., d * SB + t, :] = F[..., d * SB + t + 1, :] * \
                    wc[..., d * SB + t + 1, :]
            G.append(E[..., d * SB + SB - 1, :] * wc[..., d * SB + SB - 1, :])

        def GP(a, b):
            out = torch.ones_like(G[0])
            for e in range(a, b):
                out = out * G[e]
            return out
        return E, F, GP

    chunks = [slice(c * L, (c + 1) * L) for c in range(nc)]
    # the state pass
    Sc, dSe = [], [None] * nc
    for sl in chunks:
        Sc.append(S)
        E, F, GP = decays(ww[:, :, sl])
        kbar = kk[:, :, sl] * F * torch.stack(
            [GP(d + 1, 4) for d in range(4)], 2).repeat_interleave(SB, 2)
        S = GP(0, 4)[..., None] * S + kbar.transpose(-1, -2) @ vv[:, :, sl]
    for c in range(nc - 1, -1, -1):
        dSe[c] = dS
        sl = chunks[c]
        E, F, GP = decays(ww[:, :, sl])
        rdec = rr[:, :, sl] * E * torch.stack(
            [GP(0, d) for d in range(4)], 2).repeat_interleave(SB, 2)
        dS = GP(0, 4)[..., None] * dS + rdec.transpose(-1, -2) @ gg[:, :, sl]
    dS0 = dS

    dr, dk, dv, dw = (torch.zeros((B, H, nc * L, D), dtype=f64)
                      for _ in range(4))
    du = torch.zeros((B, H, D), dtype=f64)
    for c, sl in enumerate(chunks):
        rc, kc, vc, wc, gc = (x[:, :, sl] for x in (rr, kk, vv, ww, gg))
        E, F, GP = decays(wc)
        kF, rE = kc * F, rc * E
        dA = gc @ vc.transpose(-1, -2)                  # dy_t . v_s
        cvec = torch.diagonal(dA, dim1=-2, dim2=-1)
        dYS = gc @ Sc[c].transpose(-1, -2)              # [t, i]
        VdS = vc @ dSe[c].transpose(-1, -2)             # [s, i]
        rowsum = (Sc[c] * dSe[c]).sum(-1)
        blk = [slice(d * SB, (d + 1) * SB) for d in range(4)]
        temp = [dA[..., :, blk[c_]] @ kF[..., blk[c_], :] for c_ in range(3)]
        tempT = {d: dA[..., blk[d], :].transpose(-1, -2) @ rE[..., blk[d], :]
                 for d in range(1, 4)}
        X, K = torch.empty_like(dYS), torch.empty_like(VdS)
        M = {1: 0.0, 2: 0.0}
        for e in range(4):
            X[..., blk[e], :] = GP(0, e)[..., None, :] * dYS[..., blk[e], :]
            K[..., blk[e], :] = GP(e + 1, 4)[..., None, :] * \
                VdS[..., blk[e], :]
            for c_ in range(e):
                X[..., blk[e], :] += GP(c_ + 1, e)[..., None, :] * \
                    temp[c_][..., blk[e], :]
                for d in (1, 2):
                    if c_ < d < e:
                        M[d] = M[d] + (GP(d + 1, e) * GP(c_ + 1, d)) * (
                            rE[..., blk[e], :] * temp[c_][..., blk[e], :]
                        ).sum(-2)
            for d in range(e + 1, 4):
                K[..., blk[e], :] += GP(e + 1, d)[..., None, :] * \
                    tempT[d][..., blk[e], :]
        rho = {e: (rE[..., blk[e], :] * dYS[..., blk[e], :]).sum(-2)
               for e in range(4)}
        phi = {e: (kF[..., blk[e], :] * VdS[..., blk[e], :]).sum(-2)
               for e in range(4)}
        # A as the forward kernel forms it: blocks past the diagonal from
        # rhat khat^T, the diagonal blocks summed directly
        A = torch.zeros_like(dA)
        for c_ in range(3):
            for e in range(c_ + 1, 4):
                A[..., blk[e], blk[c_]] = (rE[..., blk[e], :] * GP(
                    c_ + 1, e)[..., None, :]) @ kF[..., blk[c_], :] \
                    .transpose(-1, -2)
        bonus = (rc * uu[None, :, None, :] * kc).sum(-1)
        for d in range(4):
            for t in range(d * SB, (d + 1) * SB):
                for s in range(d * SB, t):
                    A[..., t, s] = (rc[..., t, :] * kc[..., s, :] *
                                    _decay(wc, s + 1, t - 1)).sum(-1)
        kbar = kF * torch.stack([GP(d + 1, 4) for d in range(4)],
                                2).repeat_interleave(SB, 2)
        dv[:, :, sl] = kbar @ dSe[c] + A.transpose(-1, -2) @ gc + \
            bonus[..., None] * gc
        # per sub-chunk: the scans, the diagonal blocks, dw
        for d in range(4):
            Cd = GP(0, d) * GP(d + 1, 4) * rowsum
            if d in M:
                Cd = Cd + M[d]
            for e in range(d + 1, 4):
                Cd = Cd + GP(0, d) * GP(d + 1, e) * rho[e]
            for e in range(d):
                Cd = Cd + GP(d + 1, 4) * GP(e + 1, d) * phi[e]
            ts = range(d * SB, (d + 1) * SB)
            U = {t: torch.zeros_like(rowsum) for t in ts}
            Gk = torch.zeros_like(rowsum)
            part = {}
            for t in ts:
                h = torch.zeros_like(rowsum)
                for tau in range((d + 1) * SB - 1, t, -1):
                    h = rc[..., tau, :] * U[tau] + wc[..., tau, :] * h
                dr[:, :, c * L + t] = E[..., t, :] * X[..., t, :] + U[t] + \
                    cvec[..., t, None] * uu * kc[..., t, :]
                part[t] = E[..., t, :] * F[..., t, :] * Cd + \
                    F[..., t, :] * Gk + h
                Gk = wc[..., t, :] * Gk + kc[..., t, :] * K[..., t, :]
                for tau in range(t + 1, (d + 1) * SB):
                    U[tau] = wc[..., t, :] * U[tau] + \
                        dA[..., tau, t, None] * kc[..., t, :]
            Qx = torch.zeros_like(rowsum)
            for s in reversed(ts):
                h = torch.zeros_like(rowsum)
                for t in range((d + 1) * SB - 1, s, -1):
                    h = dA[..., t, s, None] * rc[..., t, :] + \
                        wc[..., t, :] * h
                dk[:, :, c * L + s] = F[..., s, :] * K[..., s, :] + h + \
                    cvec[..., s, None] * uu * rc[..., s, :]
                dw[:, :, c * L + s] = part[s] + E[..., s, :] * Qx
                Qx = wc[..., s, :] * Qx + rc[..., s, :] * X[..., s, :]
        du += (cvec[..., None] * rc * kc).sum(-2)
    return (dr[:, :, :T], dk[:, :, :T], dv[:, :, :T], dw[:, :, :T],
            du.sum(0), dS0)


def _decay(wc, a, b):
    """prod_{l=a..b} wc[.., l, :] (1 for an empty range)."""
    import torch

    out = torch.ones_like(wc[..., 0, :])
    for l in range(a, b + 1):
        out = out * wc[..., l, :]
    return out
