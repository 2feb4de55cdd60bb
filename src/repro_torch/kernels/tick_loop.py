"""The fused whole-transfer tick loop: a hand-written CUDA kernel and its
plain PyTorch version.

:func:`tick_loop` replaces the JAX package's Pallas TPU kernel
``repro/core/engine.py::_build_pallas_core``: one launch runs every lane
(transfer) of a batch from its packed initial rows to completion or to the
horizon, and writes the seven per-tick traces; :func:`tick_loop_grouped`
runs several batches (a sweep's groups) in one launch per partition count
among them.  The kernel is ``csrc/tick_loop.cu`` (built by
:mod:`repro_torch.kernels.build`); it spells out the built-in controllers
(ME / EEMT / EETT with or without load control, Ismail's target tuner, the
static baselines, and the learned controller of ``repro_torch.learn``,
whose MLP weights ride in as the controller's own device table,
``LearnedController.table``) and the built-in environments — the
reference, lossy-wan and logfit network models, the reference, big-little
and dvfs energy models, in any pairing — and raises for anything else
(:func:`kernel_spec`).

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
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine, tickstate
from repro_torch.core._f32 import sum_lr
from repro_torch.core.types import CpuProfile, SLAPolicy, TickMetrics

#: Controller codes of the kernel's ``KIND`` template parameter.
KIND_ME, KIND_EEMT, KIND_EETT, KIND_ISMAIL, KIND_STATIC, KIND_LEARNED = \
    range(6)
_POLICY_KIND = {SLAPolicy.MIN_ENERGY: KIND_ME,
                SLAPolicy.MAX_THROUGHPUT: KIND_EEMT,
                SLAPolicy.TARGET_THROUGHPUT: KIND_EETT,
                SLAPolicy.ISMAIL_TARGET: KIND_ISMAIL}

MAX_PARTITIONS = 8   # the kernel is instantiated for P = 1..8
#: Groups one launch takes (csrc/tick_loop.cu kMaxGroups: the descriptors
#: ride in the kernel's parameters).
MAX_GROUPS = 60
MAX_FREQ_LEVELS = 16
MAX_VF_POINTS = 16   # dvfs V(f) tables ride by value, as the ladder does
#: The learned controller's MLP: layers, width of any layer, and the input
#: and output widths the kernel spells out (9 features, 3 heads x 3).
MAX_POLICY_LAYERS = 4
MAX_POLICY_WIDTH = 64
POLICY_IO = 9

#: Environment codes of the kernel's argument struct.
NET_REFERENCE, NET_LOSSY_WAN, NET_LOGFIT = range(3)
ENERGY_REFERENCE, ENERGY_BIG_LITTLE, ENERGY_DVFS = range(3)
#: Slots of the float32 environment constants, then the V(f) table.
ENV_CONSTS = ("w_loss", "knee_div", "jitter_rate", "jitter_frac", "bin_s",
              "rtt_fit", "n_big", "little_perf", "little_dyn",
              "little_static", "cap_nf", "leak_w", "leak_w_per_v",
              "idle_leak", "max_freq")
#: Slots of the int environment codes.
ENV_CODES = ("network", "energy", "loss", "jitter", "fit_rtt", "race",
             "capped", "n_vf", "n_bins")


class EnvSpec(NamedTuple):
    """An environment as the kernel's arguments: ``codes`` (the
    :data:`ENV_CODES`), ``consts`` (the :data:`ENV_CONSTS` as float32, then
    the V(f) table padded to :data:`MAX_VF_POINTS` frequencies and as many
    volts) and the logfit schedule (``()`` otherwise)."""

    codes: tuple
    consts: np.ndarray
    schedule: tuple

    @property
    def network(self) -> int:
        return self.codes[0]

    @property
    def energy(self) -> int:
        return self.codes[1]

    @property
    def reference(self) -> bool:
        """Whether the reference kernel (no environment code) runs it."""
        return (self.network == NET_REFERENCE
                and self.energy == ENERGY_REFERENCE)


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


def _alloc_obs(n_steps: int, n_lanes: int, device):
    """Time-major Observation buffers pre-filled with the never-executed-tick
    values: every field zero (``is_ctrl`` and ``live`` False), as the
    masked step emits after completion."""
    return engine.Observation(*[
        torch.zeros((n_steps, n_lanes), dtype=dtype, device=device)
        for dtype in engine.OBS_DTYPES])


def _n_partitions(prow) -> int:
    return (prow.shape[-1] - tickstate.N_NET - tickstate.N_SLA) // 5


@torch.inference_mode()
def tick_loop_reference(controller, env, cpu: CpuProfile, prow, bw, f0, i0,
                        *, dt: float, ctrl_every: int,
                        observe: bool = False):
    """Plain PyTorch tick loop over a lane batch (any device).

    Drives :func:`repro_torch.core.engine.make_step_fn` one tick at a time
    over all lanes, with completion masking, in chunks of ticks; it stops
    after the first chunk in which every lane is done.  With
    ``observe=True`` it also returns the :class:`~repro_torch.core.engine.
    Observation` trace, ``[B, n_steps]`` views of time-major buffers like
    the metrics.
    """
    n_lanes, n_steps = bw.shape
    lay = tickstate.TickLayout(_n_partitions(prow))
    fields = lay.unpack_params(prow)
    sim, ts = lay.unpack_state(f0, i0)
    inp = engine.ScanInputs(state0=ts, bw=bw, **fields)
    chunk, n_chunks, padded = engine._chunking(n_steps)
    step = engine.make_step_fn(
        controller, env, cpu, inp, dt=dt, ctrl_every=ctrl_every,
        n_steps=n_steps if padded != n_steps else None, observe=observe)
    out = _alloc_traces(n_steps, n_lanes, bw.device)
    if observe:
        out = (*out, *_alloc_obs(n_steps, n_lanes, bw.device))
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
                ms.append((*m[0], *m[1]) if observe else m)
        for buf, vals in zip(out, zip(*ms)):
            buf[start:stop] = torch.stack(vals).to(buf.dtype)

    f32, i32 = lay.pack_state(sim, ts)
    n_m = len(TickMetrics._fields)
    metrics = TickMetrics(*[b.t() for b in out[:n_m]])
    if not observe:
        return f32, i32, metrics
    return f32, i32, metrics, engine.Observation(*[b.t() for b in out[n_m:]])


def env_spec(env) -> EnvSpec:
    """The kernel's arguments for an environment, or raise for a model type
    the kernel has no code for.  Every constant is the float32 rounding of
    the Python double expression the plain version (and the JAX package)
    applies."""
    from repro_torch.api import environments as E
    from repro_torch.workloads.logfit import LogFitNetworkModel

    net, en = env.network, env.energy
    codes = dict.fromkeys(ENV_CODES, 0)
    c = dict.fromkeys(ENV_CONSTS, 0.0)
    vf_f, vf_v, schedule = (), (), ()
    if type(net) in (E.ReferenceNetworkModel, E.DvfsNetworkModel):
        codes["network"] = NET_REFERENCE
    elif type(net) is E.LossyWanNetworkModel:
        codes["network"] = NET_LOSSY_WAN
        codes["loss"] = int(net.loss_rate > 0.0)
        codes["jitter"] = int(net.jitter_frac > 0.0)
        if codes["loss"]:
            c["w_loss"] = net.window_cap()
            c["knee_div"] = net.knee_divisor()
        if codes["jitter"]:
            c["jitter_rate"] = net.jitter_rate()
            c["jitter_frac"] = net.jitter_frac
    elif type(net) is LogFitNetworkModel:
        codes["network"] = NET_LOGFIT
        codes["fit_rtt"] = int(net.rtt_s is not None)
        c["bin_s"] = net.bin_s
        c["rtt_fit"] = net.rtt_s or 0.0
        schedule = net.bw_mbps
        codes["n_bins"] = len(schedule)
    else:
        raise ValueError(
            f"the CUDA tick kernel has no code for network model "
            f"{type(net).__name__} (it implements the reference environment "
            f"and the lossy-wan, logfit, big-little and dvfs families); use "
            f"executor='reference'")
    if type(en) is E.ReferenceEnergyModel:
        codes["energy"] = ENERGY_REFERENCE
    elif type(en) is E.BigLittleEnergyModel:
        codes["energy"] = ENERGY_BIG_LITTLE
        c.update(n_big=float(en.n_big), little_perf=en.little_perf,
                 little_dyn=en.little_dyn_frac,
                 little_static=en.little_static_frac)
    elif type(en) is E.DvfsEnergyModel:
        if len(en.vf_ghz) > MAX_VF_POINTS:
            raise ValueError(f"the CUDA tick kernel takes V(f) tables of at "
                             f"most {MAX_VF_POINTS} points, got "
                             f"{len(en.vf_ghz)}")
        codes["energy"] = ENERGY_DVFS
        codes["race"] = int(en.idle == "race")
        codes["capped"] = int(en.max_freq_ghz is not None)
        codes["n_vf"] = len(en.vf_ghz)
        c.update(n_big=float(en.n_big), little_perf=en.little_perf,
                 little_dyn=en.little_cap_frac,
                 little_static=en.little_leak_frac, cap_nf=en.cap_nf,
                 leak_w=en.leak_w, leak_w_per_v=en.leak_w_per_v,
                 idle_leak=en.idle_leak_frac,
                 max_freq=en.max_freq_ghz or 0.0)
        vf_f, vf_v = en.vf_ghz, en.vf_volt
    else:
        raise ValueError(
            f"the CUDA tick kernel has no code for energy model "
            f"{type(en).__name__} (it implements the reference environment "
            f"and the big-little and dvfs families); use "
            f"executor='reference'")
    pad = [0.0] * (MAX_VF_POINTS - len(vf_f))
    consts = np.asarray([c[k] for k in ENV_CONSTS] + list(vf_f) + pad
                        + list(vf_v) + pad, np.float32)
    return EnvSpec(tuple(codes[k] for k in ENV_CODES), consts, schedule)


def policy_widths(controller) -> tuple:
    """The layer widths of a learned controller's MLP (inputs, hidden...,
    outputs), or raise for a policy the kernel does not take."""
    cfg = controller.cfg
    widths = (cfg.obs_dim, *cfg.hidden, cfg.out_dim)
    n_layers = len(widths) - 1
    if n_layers > MAX_POLICY_LAYERS:
        raise ValueError(f"the CUDA tick kernel takes learned policies of at "
                         f"most {MAX_POLICY_LAYERS} layers, got {n_layers}")
    if max(widths) > MAX_POLICY_WIDTH:
        raise ValueError(f"the CUDA tick kernel takes learned policies with "
                         f"layers at most {MAX_POLICY_WIDTH} wide, got "
                         f"widths {widths}")
    if widths[0] != POLICY_IO or widths[-1] != POLICY_IO:
        raise ValueError(f"the CUDA tick kernel takes learned policies of "
                         f"{POLICY_IO} features and {POLICY_IO} logits, got "
                         f"widths {widths}")
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        if (controller.params[f"w{i}"].shape != (n_in, n_out)
                or controller.params[f"b{i}"].shape != (n_out,)):
            raise ValueError(f"learned policy layer {i}: params do not "
                             f"match widths {widths}")
    return widths


def kernel_spec(controller, env) -> tuple[int, bool, EnvSpec]:
    """(KIND, scaling, environment) arguments of the kernel for a controller
    code and an environment, or raise: the kernel spells out the built-in
    controllers and environments only, and learned policies within the
    :data:`MAX_POLICY_LAYERS` / :data:`MAX_POLICY_WIDTH` limits."""
    from repro_torch.api.controllers import (IsmailTargetController,
                                             StaticBaselineController,
                                             TunerController)
    from repro_torch.learn.controller import LearnedController

    spec = env_spec(env)
    if type(controller) is TunerController:
        return (_POLICY_KIND[controller.sla.policy], bool(controller.scaling),
                spec)
    if type(controller) is IsmailTargetController:
        return KIND_ISMAIL, False, spec
    if type(controller) is StaticBaselineController:
        return KIND_STATIC, False, spec
    if type(controller) is LearnedController:
        policy_widths(controller)
        return KIND_LEARNED, False, spec
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
    :func:`tick_loop_reference`; for CUDA tensors it is
    :func:`tick_loop_grouped` of the one batch (no launch for B = 0).
    """
    return tick_loop_grouped([(controller, env, cpu, prow, bw, f0, i0, dt,
                               ctrl_every)])[0]


def _marshal(controller, env, cpu: CpuProfile, prow, bw, f0, i0, *,
             dt: float, ctrl_every: int):
    """Allocate a lane batch's outputs and marshal the arguments of
    ``tick_loop_set_group`` (``csrc/tick_loop.cu``) after the descriptor
    buffer and index.  Returns (arguments, (f32, i32, TickMetrics), tensors
    the launch reads): the caller keeps the last alive until the launch is
    enqueued."""
    kind, scaling, spec = kernel_spec(controller, env)
    n_lanes, n_steps = bw.shape
    prow, f0, i0 = prow.contiguous(), f0.contiguous(), i0.contiguous()
    bw_t = bw.t().contiguous()                     # time-major [n_steps, B]
    fout = torch.empty_like(f0)
    iout = torch.empty_like(i0)
    out = _alloc_traces(n_steps, n_lanes, prow.device)
    consts, n_freq = _cpu_consts(cpu)
    env_codes = (ctypes.c_int * len(spec.codes))(*spec.codes)
    env_consts = (ctypes.c_float * len(spec.consts))(*spec.consts.tolist())
    bins = (tickstate.const_table(spec.schedule, prow.device).data_ptr()
            if spec.schedule else None)
    policy, widths, n_layers = None, None, 0
    if kind == KIND_LEARNED:
        w = policy_widths(controller)
        policy = controller.table(prow.device).data_ptr()
        widths = (ctypes.c_int * len(w))(*w)
        n_layers = len(w) - 1
    args = (_n_partitions(prow), kind, int(scaling),
            prow.data_ptr(), bw_t.data_ptr(), f0.data_ptr(),
            i0.data_ptr(), fout.data_ptr(), iout.data_ptr(),
            *[buf.data_ptr() for buf in out],
            n_lanes, n_steps, int(ctrl_every),
            float(np.float32(dt)), consts, n_freq,
            int(cpu.num_cores), env_codes, env_consts, bins,
            policy, widths, n_layers)
    return args, (fout, iout, TickMetrics(*[b.t() for b in out])), \
        (prow, bw_t, f0, i0)


def marshal_and_launch_groups(lib, launch, batches, *, stream):
    """Marshal every lane batch of ``batches`` (see :func:`tick_loop_grouped`;
    one partition count, at least one lane each) into one table of group
    descriptors (``tick_loop_set_group`` of ``lib``) and call ``launch``
    (``tick_loop_grouped_launch``'s signature) once on it.  Returns (error
    code, [(f32, i32, TickMetrics)] in order).  The tensors' device is the
    caller's business: :func:`tick_loop_grouped` hands CUDA tensors to the
    CUDA library; tests/test_torch_tick_loop_host.py hands CPU tensors to
    the same source compiled for the host."""
    n = len(batches)
    table = ctypes.create_string_buffer(lib.tick_loop_group_bytes() * n)
    outs, keep = [], []     # keep: what the launch reads, alive until then
    for i, (controller, env, cpu, prow, bw, f0, i0, dt, ctrl_every) in \
            enumerate(batches):
        args, out, k = _marshal(controller, env, cpu, prow, bw, f0, i0,
                                dt=dt, ctrl_every=ctrl_every)
        err = lib.tick_loop_set_group(table, i, *args)
        if err != 0:
            return err, None
        outs.append(out)
        keep.append(k)
    return launch(_n_partitions(batches[0][3]), table, n, stream), outs


def launch_groups(lib, launch, batches, *, stream):
    """Run ``batches`` (see :func:`tick_loop_grouped`) in as few launches
    of ``launch`` as the kernel takes: one per partition count among them
    (and per :data:`MAX_GROUPS` batches of one count), the batches of no
    lane in none.  Returns (error code, [(f32, i32, TickMetrics)] in order,
    launches); on an error the outputs are None.  As
    :func:`marshal_and_launch_groups`, the device is the caller's
    business."""
    outs = [None] * len(batches)
    by_p: dict[int, list[int]] = {}
    for i, (c, e, cpu, prow, bw, f0, i0, dt, ce) in enumerate(batches):
        if bw.shape[0]:
            by_p.setdefault(_n_partitions(prow), []).append(i)
        else:
            outs[i] = _marshal(c, e, cpu, prow, bw, f0, i0, dt=dt,
                               ctrl_every=ce)[1]
    launches = 0
    for idxs in by_p.values():
        for k in range(0, len(idxs), MAX_GROUPS):
            chunk = idxs[k:k + MAX_GROUPS]
            err, out = marshal_and_launch_groups(
                lib, launch, [batches[i] for i in chunk], stream=stream)
            if err != 0:
                return err, None, launches
            launches += 1
            for i, o in zip(chunk, out):
                outs[i] = o
    return 0, outs, launches


@torch.inference_mode()
def tick_loop_grouped(batches):
    """Run several lane batches — a sweep's groups — through the CUDA tick
    kernel (``tick_loop_grouped_kernel``) in one launch per partition count
    among them.

    ``batches`` is a list of ``(controller, env, cpu, prow, bw, f0, i0,
    dt, ctrl_every)``, each batch as :func:`tick_loop` takes it, all on one
    device.  Returns one ``(f32, i32, TickMetrics)`` per batch, bit for bit
    what :func:`tick_loop_reference` returns for it.  For CPU tensors each
    batch runs :func:`tick_loop_reference`; for CUDA tensors this launches
    the kernel (:func:`launch_groups`) on the current stream without
    synchronising, or raises."""
    if not batches:
        return []
    dev = batches[0][3].device
    if dev.type == "cpu":
        return [tick_loop_reference(c, e, cpu, prow, bw, f0, i0, dt=dt,
                                    ctrl_every=ce)
                for c, e, cpu, prow, bw, f0, i0, dt, ce in batches]
    if dev.type != "cuda":
        raise ValueError(f"tick_loop runs on CUDA (or, as its plain "
                         f"version, on the CPU), got {dev}")
    for _, _, _, prow, bw, f0, i0, _, _ in batches:
        n_lanes, n_steps = bw.shape
        p = _n_partitions(prow)
        if not 1 <= p <= MAX_PARTITIONS:
            raise ValueError(f"the CUDA tick kernel takes 1..{MAX_PARTITIONS}"
                             f" partitions, got {p}")
        lay = tickstate.TickLayout(p)
        _check("prow", prow, torch.float32, (n_lanes, lay.params_size), dev)
        _check("bw", bw, torch.float32, (n_lanes, n_steps), dev)
        _check("f0", f0, torch.float32, (n_lanes, lay.f32_size), dev)
        _check("i0", i0, torch.int32, (n_lanes, lay.i32_size), dev)
        if n_steps >= 2 ** 31 // max(n_lanes, 1):
            raise ValueError("tick_loop: n_steps * B must fit in int32")

    from . import build

    lib = build.load_tick_loop()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err, outs, launches = launch_groups(
            lib, lib.tick_loop_grouped_launch, batches, stream=stream)
    tick_loop.launches += launches
    if err != 0:
        raise RuntimeError(f"tick_loop kernel launch failed: "
                           f"{build.cuda_error_string(lib, err)}")
    return outs


#: Kernel launches since the last reset (set to 0 to start counting):
#: :func:`tick_loop` and :func:`tick_loop_grouped` count here, once per
#: launch.
tick_loop.launches = 0
