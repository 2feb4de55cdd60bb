"""The fused whole-transfer tick loop: a hand-written CUDA kernel and its
plain PyTorch version.

:func:`tick_loop` replaces the JAX package's Pallas TPU kernel
``repro/core/engine.py::_build_pallas_core``: one launch runs every lane
(transfer) of a batch from its packed initial rows to completion or to the
horizon, and writes the seven per-tick traces.  The kernel is
``csrc/tick_loop.cu`` (built by :mod:`repro_torch.kernels.build`); it spells
out the reference environment's physics and the built-in controllers (ME /
EEMT / EETT with or without load control, Ismail's target tuner, the static
baselines), and raises for anything else.

:func:`tick_loop_reference` has the same signature and computes the same
function with eager tensor ops: it is the engine's ``reference`` executor,
what :func:`tick_loop` runs for tensors on the CPU, and what the kernel is
held to bit for bit on the card.

Both return ``(f32 [B, 2P+9], i32 [B, 3], TickMetrics)``; every trace is
``[B, n_steps]`` with ``done`` as int32 (1 from the tick the lane drained
on, and on every tick never executed).  The traces are views of time-major
``[n_steps, B]`` buffers — the kernel's stores coalesce across the lanes of
a warp that way — and the plain version uses the same layout.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import engine, tickstate
from repro_torch.core._f32 import sum_lr
from repro_torch.core.types import CpuProfile, SLAPolicy, TickMetrics

#: Controller codes of the kernel's ``KIND`` template parameter.
KIND_ME, KIND_EEMT, KIND_EETT, KIND_ISMAIL, KIND_STATIC = range(5)
_POLICY_KIND = {SLAPolicy.MIN_ENERGY: KIND_ME,
                SLAPolicy.MAX_THROUGHPUT: KIND_EEMT,
                SLAPolicy.TARGET_THROUGHPUT: KIND_EETT,
                SLAPolicy.ISMAIL_TARGET: KIND_ISMAIL}

MAX_PARTITIONS = 8   # the kernel is instantiated for P = 1..8
MAX_FREQ_LEVELS = 16


def _alloc_traces(n_steps: int, n_lanes: int, device):
    """Time-major trace buffers pre-filled with the never-executed-tick
    values: zero metrics, ``done`` = 1."""
    def z(dtype):
        return torch.zeros((n_steps, n_lanes), dtype=dtype, device=device)
    return TickMetrics(
        tput_mbps=z(torch.float32), power_w=z(torch.float32),
        cpu_load=z(torch.float32), num_ch=z(torch.float32),
        cores=z(torch.int32), freq_ghz=z(torch.float32),
        done=torch.ones((n_steps, n_lanes), dtype=torch.int32,
                        device=device))


def _n_partitions(prow) -> int:
    return (prow.shape[-1] - tickstate.N_NET - tickstate.N_SLA) // 5


@torch.inference_mode()
def tick_loop_reference(controller, env, cpu: CpuProfile, prow, bw, f0, i0,
                        *, dt: float, ctrl_every: int):
    """Plain PyTorch tick loop over a lane batch (any device).

    Drives :func:`repro_torch.core.engine.make_step_fn` one tick at a time
    over all lanes, with completion masking, in chunks of ticks; it stops
    after the first chunk in which every lane is done.
    """
    n_lanes, n_steps = bw.shape
    lay = tickstate.TickLayout(_n_partitions(prow))
    fields = lay.unpack_params(prow)
    sim, ts = lay.unpack_state(f0, i0)
    inp = engine.ScanInputs(state0=ts, bw=bw, **fields)
    chunk, n_chunks, padded = engine._chunking(n_steps)
    step = engine.make_step_fn(
        controller, env, cpu, inp, dt=dt, ctrl_every=ctrl_every,
        n_steps=n_steps if padded != n_steps else None)
    out = _alloc_traces(n_steps, n_lanes, bw.device)
    zero_bw = torch.zeros((n_lanes,), dtype=torch.float32, device=bw.device)

    for k in range(n_chunks):
        if not bool((sum_lr(sim.remaining_mb) > 0.0).any()):
            break
        start = k * chunk
        stop = min(start + chunk, n_steps)
        ms = []
        for i in range(start, start + chunk):
            (sim, ts), m = step((sim, ts), (i, bw[:, i] if i < n_steps
                                            else zero_bw))
            if i < stop:
                ms.append(m)
        for buf, vals in zip(out, zip(*ms)):
            buf[start:stop] = torch.stack(vals).to(buf.dtype)

    f32, i32 = lay.pack_state(sim, ts)
    return f32, i32, TickMetrics(*[b.t() for b in out])


def kernel_spec(controller, env) -> tuple[int, bool]:
    """(KIND, scaling) template arguments for a controller code, or raise:
    the kernel spells out the reference environment and the built-in
    controllers only."""
    from repro_torch.api.controllers import (IsmailTargetController,
                                             StaticBaselineController,
                                             TunerController)
    from repro_torch.api.environments import (ReferenceEnergyModel,
                                              ReferenceNetworkModel)

    if not (type(env.network) is ReferenceNetworkModel
            and type(env.energy) is ReferenceEnergyModel):
        raise ValueError(f"the CUDA tick kernel implements the reference "
                         f"environment only, got {env.name!r}; use "
                         f"executor='reference'")
    if type(controller) is TunerController:
        return _POLICY_KIND[controller.sla.policy], bool(controller.scaling)
    if type(controller) is IsmailTargetController:
        return KIND_ISMAIL, False
    if type(controller) is StaticBaselineController:
        return KIND_STATIC, False
    raise ValueError(f"the CUDA tick kernel has no code for controller "
                     f"{type(controller).__name__}; use "
                     f"executor='reference'")


def _cpu_consts(cpu: CpuProfile):
    """The CpuProfile as the kernel's by-value argument: 7 float32 scalars
    then the frequency ladder padded to MAX_FREQ_LEVELS."""
    levels = tuple(cpu.freq_levels_ghz)
    if not 1 <= len(levels) <= MAX_FREQ_LEVELS:
        raise ValueError(f"the CUDA tick kernel takes 1..{MAX_FREQ_LEVELS} "
                         f"frequency levels, got {len(levels)}")
    vals = [cpu.ipc, cpu.cycles_per_byte, cpu.cycles_per_byte_per_ch,
            cpu.pkg_static_w, cpu.core_static_w, cpu.core_dyn_w_per_ghz3,
            cpu.mem_w_per_mbps] + list(levels)
    vals += [0.0] * (7 + MAX_FREQ_LEVELS - len(vals))
    arr = np.asarray(vals, np.float32)
    return (ctypes.c_float * len(arr))(*arr.tolist()), len(levels)


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"tick_loop: {name} must be {dtype} {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


@torch.inference_mode()
def tick_loop(controller, env, cpu: CpuProfile, prow, bw, f0, i0, *,
              dt: float, ctrl_every: int):
    """Run a lane batch through the CUDA tick kernel (one launch).

    ``prow`` [B, 13+5P] f32, ``bw`` [B, n_steps] f32, ``f0`` [B, 2P+9] f32
    and ``i0`` [B, 3] i32, all on one device.  For CPU tensors this is
    :func:`tick_loop_reference`; for CUDA tensors it launches the kernel on
    the current stream without synchronising, or raises.
    """
    if prow.device.type == "cpu":
        return tick_loop_reference(controller, env, cpu, prow, bw, f0, i0,
                                   dt=dt, ctrl_every=ctrl_every)
    if prow.device.type != "cuda":
        raise ValueError(f"tick_loop runs on CUDA (or, as its plain version, "
                         f"on the CPU), got {prow.device}")
    kind, scaling = kernel_spec(controller, env)
    n_lanes, n_steps = bw.shape
    p = _n_partitions(prow)
    if not 1 <= p <= MAX_PARTITIONS:
        raise ValueError(f"the CUDA tick kernel takes 1..{MAX_PARTITIONS} "
                         f"partitions, got {p}")
    lay = tickstate.TickLayout(p)
    dev = prow.device
    _check("prow", prow, torch.float32, (n_lanes, lay.params_size), dev)
    _check("bw", bw, torch.float32, (n_lanes, n_steps), dev)
    _check("f0", f0, torch.float32, (n_lanes, lay.f32_size), dev)
    _check("i0", i0, torch.int32, (n_lanes, lay.i32_size), dev)
    if n_steps >= 2 ** 31 // max(n_lanes, 1):
        raise ValueError("tick_loop: n_steps * B must fit in int32")

    from . import build

    lib = build.load_tick_loop()
    prow, f0, i0 = prow.contiguous(), f0.contiguous(), i0.contiguous()
    bw_t = bw.t().contiguous()                     # time-major [n_steps, B]
    fout = torch.empty_like(f0)
    iout = torch.empty_like(i0)
    out = _alloc_traces(n_steps, n_lanes, dev)
    consts, n_freq = _cpu_consts(cpu)
    if n_lanes:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.tick_loop_launch(
                p, kind, int(scaling),
                prow.data_ptr(), bw_t.data_ptr(), f0.data_ptr(),
                i0.data_ptr(), fout.data_ptr(), iout.data_ptr(),
                *[buf.data_ptr() for buf in out],
                n_lanes, n_steps, int(ctrl_every), float(np.float32(dt)),
                consts, n_freq, int(cpu.num_cores), stream)
        if err != 0:
            raise RuntimeError(f"tick_loop kernel launch failed: "
                               f"{build.cuda_error_string(lib, err)}")
        tick_loop.launches += 1
    return fout, iout, TickMetrics(*[b.t() for b in out])


#: Kernel launches since the last reset (set to 0 to start counting).
tick_loop.launches = 0
