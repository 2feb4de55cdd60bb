"""Transfer engine: the tick semantics, and the executors that drive them.

The engine composes any ``repro_torch.api`` Environment (a NetworkModel +
EnergyModel pair — the physics) with any object implementing the Controller
protocol (the algorithm).  It only drives the clock.

How simulation time works
-------------------------
A transfer gets a padded horizon of ``n_steps`` ticks of ``dt`` seconds, but
is only *simulated* until it drains:

* **Completion masking.**  Every tick computes a per-lane ``live`` flag (the
  transfer still has bytes remaining and the tick is inside the horizon).
  Once the last partition drains, the whole state — ``energy_j``, ``t``,
  ``window_mb``, the controller accumulators — freezes at its completion
  value, and all emitted per-tick metrics are masked to zero.
* **Early exit.**  The ``reference`` executor runs the horizon in chunks of
  ticks and stops after the first chunk in which every lane of the batch is
  done; the ``cuda`` executor's kernel stops each lane on its own.  Ticks
  never executed hold the post-completion values (zero metrics,
  ``done=True``), so every executor returns identical traces.
* **Done semantics.**  ``TickMetrics.done[:, i]`` is recorded *after* tick
  ``i``: the completion time is ``(argmax(done) + 1) * dt``, and ``t``
  freezes at exactly that value.

Executors
---------
Both take a lane batch in the flat rows of
:class:`repro_torch.core.tickstate.TickLayout` and call one function of
:mod:`repro_torch.kernels.tick_loop`:

* ``reference`` — ``tick_loop_reference``: the eager PyTorch tick loop that
  drives :func:`make_step_fn` over the whole batch, one tensor op at a time.
  It runs on any device and is the plain version the kernel is held to.
* ``cuda`` — ``tick_loop``: one launch of the hand-written CUDA kernel for
  the whole batch (built-in environments and controllers).  Several
  batches — a sweep's groups — run together through
  :func:`run_cuda_groups`: one launch for all that share a partition
  count.

``executor="auto"`` resolves per device (:func:`resolve_executor`): ``cuda``
on a CUDA device, ``reference`` on the CPU.  The plain version runs on a
card only when the caller names it.

Observation hook
----------------
``observe=True`` (:func:`make_step_fn`, :func:`build_core`,
:func:`get_runner`) adds a per-tick :class:`Observation` trace for the
``repro_torch.learn`` rollout harness.  Only the ``reference`` executor
emits it (the kernel has no observation outputs, as the JAX package's
Pallas kernel has none): ``auto`` resolves to ``reference`` on any device
when the hook is on, and an explicit ``cuda`` raises.  The flag is read
when the step is built, so the unobserved path runs exactly the ops it ran
before the hook existed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import tickstate
from . import tuners
from ._f32 import ftz, select, sum_lr
from .types import (CpuProfile, NetParams, SLAParams, TickMetrics,
                    TransferParams, TunerState)

# Chunking of the reference executor's early-exit loop: the batch is checked
# for completion (one host sync) once per chunk.  Purely a performance knob —
# completion masking keeps any chunking bit-identical.  Same policy as the
# JAX package: at most MAX_CHUNKS chunks of at least MIN_CHUNK ticks.
MIN_CHUNK = 512
MAX_CHUNKS = 64

#: Executor names accepted everywhere an ``executor=`` knob exists
#: ("auto" additionally resolves per device).
EXECUTORS = ("reference", "cuda")


def resolve_executor(executor: str = "auto", device=None, *,
                     observe: bool = False) -> str:
    """Resolve an executor request for ``device`` to a concrete name.

    ``auto`` picks ``cuda`` on a CUDA device and ``reference`` on the CPU,
    and ``reference`` on any device when the observation hook is on (the
    kernel emits no :class:`Observation` traces).  ``cuda`` on a CPU device
    raises, and so does ``cuda`` with ``observe=True``.  With
    ``device=None`` only the name is validated (``auto`` passes through).
    """
    if executor != "auto" and executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; expected one of "
                         f"{('auto',) + EXECUTORS}")
    if executor == "cuda" and observe:
        raise ValueError("the cuda executor does not support observe=True; "
                         "use executor='reference' (or 'auto')")
    if device is None:
        return executor
    on_cuda = torch.device(device).type == "cuda"
    if executor == "auto":
        return "cuda" if on_cuda and not observe else "reference"
    if executor == "cuda" and not on_cuda:
        raise ValueError("the cuda executor needs a CUDA device; on the CPU "
                         "use executor='reference' (or 'auto')")
    return executor


@dataclasses.dataclass
class TransferResult:
    """Post-processed outcome of one simulated transfer.

    ``avg_tput_MBps`` is megabytes/second (the engine's internal rate unit);
    ``avg_tput_gbps`` is gigabits/second (the paper's reporting unit).
    """

    name: str
    time_s: float
    energy_j: float
    avg_tput_MBps: float          # MB/s
    avg_tput_gbps: float          # Gbit/s (paper's unit)
    avg_power_w: float
    completed: bool
    metrics: TickMetrics          # per-tick traces (numpy)

    def row(self) -> str:
        return (f"{self.name},{self.time_s:.1f},{self.energy_j:.0f},"
                f"{self.avg_tput_gbps:.3f},{self.avg_power_w:.1f}")


class ScanInputs(NamedTuple):
    """Numeric inputs to one engine run: host numpy leaves for one transfer
    (from :meth:`from_init`), or tensors with a leading lane axis."""

    net: NetParams         # testbed profile scalars
    sla: SLAParams         # tuner hyper-parameter scalars
    pp: object             # [P] pipelining depth per partition
    par: object            # [P] parallelism per partition
    total_mb: object       # [P] partition sizes
    avg_file_mb: object    # [P] average file (or chunk) size
    state0: TunerState     # initial controller state (numCh, cores, freq, ..)
    static_w: object       # [P] frozen channel weights (controller-specific)
    bw: object             # [n_steps] available-bandwidth schedule

    @classmethod
    def from_init(cls, ci, profile, n_steps: int) -> "ScanInputs":
        """Assemble host-side inputs from a ``ControllerInit`` + profile,
        with a flat bandwidth schedule (override ``bw`` via ``_replace``)."""
        return cls(
            net=NetParams.from_profile(profile),
            sla=ci.sla,
            pp=ci.params.pp,
            par=ci.params.par,
            total_mb=np.asarray([s.total_mb for s in ci.specs], np.float32),
            avg_file_mb=np.asarray([s.avg_file_mb for s in ci.specs],
                                   np.float32),
            state0=ci.state,
            static_w=np.asarray(ci.static_weights, np.float32),
            bw=np.ones((n_steps,), np.float32),
        )


class Observation(NamedTuple):
    """Per-tick rollout capture, emitted only when the engine is built with
    ``observe=True`` (the learned-controller training hook); each field is
    ``[B]`` per tick, ``[B, n_steps]`` as a trace.

    Window quantities (``avg_tput``, ``avg_power``) are computed from the
    controller accumulators with the exact expressions of
    :func:`_controller_tick`, so at controller ticks (``is_ctrl``) they are
    bit-identical to the ``Measurement`` the controller saw.  The operating
    point (``num_ch``/``cores``/``freq_idx``) is recorded *pre-decision* and
    the ``d_*`` fields hold the delta the controller applied this tick
    (zero off controller ticks).  Everything is masked to zero once the
    transfer completes, mirroring ``TickMetrics``.
    """

    avg_tput: torch.Tensor      # f32 MB/s over the accumulation window
    avg_power: torch.Tensor     # f32 W over the accumulation window
    cpu_load: torch.Tensor      # f32 utilisation of the active cores
    remaining_mb: torch.Tensor  # f32 bytes left across partitions
    num_ch: torch.Tensor        # f32 channel budget, pre-decision
    cores: torch.Tensor         # i32 active cores, pre-decision
    freq_idx: torch.Tensor      # i32 frequency index, pre-decision
    bw_scale: torch.Tensor      # f32 contention share of nominal bandwidth
    d_num_ch: torch.Tensor      # f32 channel delta applied this tick
    d_cores: torch.Tensor       # i32 core delta applied this tick
    d_freq_idx: torch.Tensor    # i32 frequency delta applied this tick
    is_ctrl: torch.Tensor       # bool controller ticked (and transfer live)
    live: torch.Tensor          # bool transfer still moving bytes


#: dtype of each Observation field.
OBS_DTYPES = Observation(
    torch.float32, torch.float32, torch.float32, torch.float32,
    torch.float32, torch.int32, torch.int32, torch.float32, torch.float32,
    torch.int32, torch.int32, torch.bool, torch.bool)


def _controller_tick(controller, ts: TunerState, sim, load, net, cpu,
                     sla) -> TunerState:
    """Assemble the interval measurement, delegate to the controller, reset
    the accumulators."""
    meas = tuners.Measurement(
        avg_tput=ftz(ts.acc_mb / ts.acc_s.clamp_min(1e-6)),
        energy_j=ts.acc_j,
        avg_power=ftz(ts.acc_j / ts.acc_s.clamp_min(1e-6)),
        remaining_mb=sum_lr(sim.remaining_mb),
        cpu_load=load,
        interval_s=ts.acc_s,
    )
    new = controller.tick(ts, meas, net, cpu, sla)
    z = torch.zeros_like(ts.acc_s)
    return new._replace(acc_mb=z, acc_j=z, acc_s=z)


def make_step_fn(controller, env, cpu: CpuProfile, inp: ScanInputs, *,
                 dt: float, ctrl_every: int, n_steps=None,
                 observe: bool = False):
    """Build the tick of a lane batch: ``step((sim, ts), (step_idx, bw))``
    returns ``((sim', ts'), TickMetrics)`` with one value per lane.

    ``step_idx`` is a Python int when every lane of the batch shares the
    clock (a run or a sweep), or a ``[B]`` int32 tensor of each lane's own
    absolute tick (a fleet wave, whose lanes were admitted at different
    ticks): the controller then ticks, masked, on the lanes where
    ``step_idx % ctrl_every == ctrl_every - 1``, as JAX's vmapped step
    does.  ``bw`` is the ``[B]`` bandwidth share of this tick.  A lane is
    ``live`` while it still has bytes remaining *and* ``step_idx <
    n_steps`` (``n_steps`` with a shared clock only); non-live lanes freeze
    their whole carry and emit zeroed metrics.

    With ``observe=True`` the step returns ``((sim', ts'), (TickMetrics,
    Observation))``; the flag is read here, so the default step is the
    program it was before the hook existed.
    """

    def step(carry, xs):
        sim, ts = carry
        step_idx, bw_scale = xs

        done = sum_lr(sim.remaining_mb) <= 0.0
        if n_steps is not None and step_idx >= n_steps:
            done = torch.ones_like(done)
        live = torch.logical_not(done)
        livef = live.to(torch.float32)

        cc = controller.channels(ts, sim, inp.static_w)
        params = TransferParams(pp=inp.pp, par=inp.par, cc=cc,
                                cores=ts.cores, freq_idx=ts.freq_idx)

        sim2, out = env.network.step(env.energy, inp.net, cpu, sim, params,
                                     inp.avg_file_mb, dt, bw_scale)
        # Completion masking: freeze the world (energy, t, windows) once the
        # transfer has completed — the clock only runs while live.
        sim2 = type(sim)(*[select(done, old, new)
                           for new, old in zip(sim2, sim)])
        sim2 = sim2._replace(t=ftz(sim.t + dt * livef))

        ts = ts._replace(
            acc_mb=ftz(ts.acc_mb + ftz(out.tput_mbps * dt) * livef),
            acc_j=ftz(ts.acc_j + ftz(out.power_w * dt) * livef),
            acc_s=ftz(ts.acc_s + dt * livef),
        )

        ts_pre = ts  # post-accumulation, pre-decision (what the tick sees)
        per_lane = isinstance(step_idx, torch.Tensor)
        ctrl_tick = controller.tunes and (
            per_lane or step_idx % ctrl_every == ctrl_every - 1)
        if ctrl_tick:
            ts_new = _controller_tick(controller, ts, sim2, out.cpu_load,
                                      inp.net, cpu, inp.sla)
            is_ctrl = live
            if per_lane:
                is_ctrl = torch.logical_and(
                    live, step_idx % ctrl_every == ctrl_every - 1)
            ts = TunerState(*[torch.where(is_ctrl, n, o)
                              for n, o in zip(ts_new, ts)])

        _, f = env.energy.operating_point(cpu, ts.cores, ts.freq_idx)
        metrics = TickMetrics(
            tput_mbps=out.tput_mbps * livef, power_w=out.power_w * livef,
            cpu_load=out.cpu_load * livef, num_ch=out.num_ch * livef,
            cores=torch.where(live, ts.cores, 0).to(torch.int32),
            freq_ghz=f * livef,
            # Recorded POST-step: True from the tick the transfer drained.
            done=sum_lr(sim2.remaining_mb) <= 0.0,
        )
        if not observe:
            return (sim2, ts), metrics

        def masked_i(x):
            return torch.where(live, x, 0).to(torch.int32)

        win_s = ts_pre.acc_s.clamp_min(1e-6)
        obs = Observation(
            avg_tput=ftz(ts_pre.acc_mb / win_s) * livef,
            avg_power=ftz(ts_pre.acc_j / win_s) * livef,
            cpu_load=out.cpu_load * livef,
            remaining_mb=sum_lr(sim2.remaining_mb) * livef,
            num_ch=ts_pre.num_ch * livef,
            cores=masked_i(ts_pre.cores),
            freq_idx=masked_i(ts_pre.freq_idx),
            bw_scale=bw_scale * livef,
            d_num_ch=ftz(ts.num_ch - ts_pre.num_ch) * livef,
            d_cores=masked_i(ts.cores - ts_pre.cores),
            d_freq_idx=masked_i(ts.freq_idx - ts_pre.freq_idx),
            is_ctrl=(is_ctrl if ctrl_tick else torch.zeros_like(live)),
            live=live,
        )
        return (sim2, ts), (metrics, obs)

    return step


def _chunking(n_steps: int):
    """(chunk, n_chunks, padded horizon) of the reference executor."""
    chunk = max(min(n_steps, max(MIN_CHUNK, -(-n_steps // MAX_CHUNKS))), 1)
    n_chunks = -(-n_steps // chunk)
    return chunk, n_chunks, n_chunks * chunk


def pack_batch(env, inp: ScanInputs):
    """A lane batch's parameter row and tick-0 state rows:
    ``(prow [B, 13+5P], f0 [B, 2P+9], i0 [B, 3])``."""
    lay = tickstate.TickLayout(inp.pp.shape[-1])
    sim0 = env.network.init_state(inp.total_mb, inp.net)
    f0, i0 = lay.pack_state(sim0, inp.state0)
    return lay.pack_params(inp), f0, i0


def build_core(controller, env, cpu: CpuProfile, *, n_steps: int, dt: float,
               ctrl_every: int, executor: str, observe: bool = False):
    """One lane batch: ScanInputs (tensors, leading lane axis, all on one
    device) -> (final SimState, TunerState, TickMetrics ``[B, n_steps]``),
    and with ``observe=True`` the :class:`Observation` trace as a fourth
    output.

    Packs the batch into the flat rows and hands them to the executor's
    tick loop (see the module docstring); ``executor`` is a concrete name.
    """
    from repro_torch.kernels import tick_loop as tl

    if executor not in EXECUTORS:
        raise ValueError(f"build_core needs a concrete executor, got "
                         f"{executor!r}")
    resolve_executor(executor, observe=observe)
    loop = tl.tick_loop if executor == "cuda" else tl.tick_loop_reference
    kw = {"observe": True} if observe else {}

    def core(inp: ScanInputs):
        if inp.bw.shape[-1] != n_steps:
            raise ValueError(f"bw has {inp.bw.shape[-1]} ticks, the runner "
                             f"was built for {n_steps}")
        prow, f0, i0 = pack_batch(env, inp)
        f32, i32, m, *obs = loop(controller, env, cpu, prow, inp.bw, f0, i0,
                                 dt=dt, ctrl_every=ctrl_every, **kw)
        sim, ts = tickstate.TickLayout(inp.pp.shape[-1]).unpack_state(f32, i32)
        return (sim, ts, m._replace(done=m.done != 0), *obs)

    return core


def run_cuda_groups(batches):
    """Several lane batches through the CUDA tick kernel together
    (``tick_loop_grouped``: one launch per partition count among them),
    each with the result its own :func:`build_core` core gives.

    ``batches`` is a list of ``(controller, env, cpu, dt, ctrl_every,
    inp)``, ``inp`` ScanInputs tensors on one CUDA device.  Returns one
    ``(SimState, TunerState, TickMetrics)`` per batch, in order."""
    from repro_torch.kernels import tick_loop as tl

    rows = []
    for ctrl, env, cpu, dt, ctrl_every, inp in batches:
        prow, f0, i0 = pack_batch(env, inp)
        rows.append((ctrl, env, cpu, prow, inp.bw, f0, i0, dt, ctrl_every))
    out = []
    for (*_, inp), (f32, i32, m) in zip(batches, tl.tick_loop_grouped(rows)):
        sim, ts = tickstate.TickLayout(inp.pp.shape[-1]).unpack_state(f32,
                                                                       i32)
        out.append((sim, ts, m._replace(done=m.done != 0)))
    return out


# ------------------------------------------------------------- waves ------
#
# The fleet (repro_torch.fleet) advances its in-flight transfers in waves
# of ``wave_steps`` ticks, each lane resuming from its carried state
# (JAX: repro/core/engine.py:692-853).  A wave lane differs from a run's in
# three ways: its clock is its own absolute tick ``step0`` (ticks since the
# transfer was admitted), so controller-tick alignment survives wave
# boundaries; its bandwidth is one share for the whole wave (the host NIC
# share), not a schedule; and a wave returns only the final rows and the
# tick the lane drained on (``done_at``; -1 while live), not traces.  Both
# forms share make_step_fn, so a transfer that never sees contention is
# bit-identical between the fleet and ``api.run``.


def build_wave_core(controller, env, cpu: CpuProfile, *, wave_steps: int,
                    dt: float, ctrl_every: int):
    """One wave of a lane batch in the state-tuple form:
    ``core(inp, sim0, ts0, step0) -> (sim', ts', done_at)``.

    ``inp`` is :class:`ScanInputs` tensors with a leading lane axis and
    ``bw`` the ``[B]`` share of each lane for the wave; ``step0`` the
    ``[B]`` int32 absolute tick of each lane at wave start.  ``done_at`` is
    ``step0`` plus the tick (within the wave) during which the lane
    drained, or -1 if it is still live after the wave; a lane drained
    before the wave gets ``step0``.  The eager loop stops once every lane
    has drained: drained lanes are frozen, so the ticks it skips are no-ops.
    """

    def core(inp: ScanInputs, sim0, ts0, step0):
        step = make_step_fn(controller, env, cpu, inp, dt=dt,
                            ctrl_every=ctrl_every)
        step0 = torch.as_tensor(step0, dtype=torch.int32)
        done_at = torch.full_like(step0, -1)
        carry = (sim0, ts0)
        for k in range(wave_steps):
            carry, m = step(carry, (step0 + k, inp.bw))
            done_at = torch.where(torch.logical_and(done_at < 0, m.done),
                                  step0 + k, done_at)
            if not bool((done_at < 0).any()):
                break
        return (*carry, done_at)

    return core


def build_blocked_wave_core(controller, env, cpu: CpuProfile, *,
                            wave_steps: int, dt: float, ctrl_every: int,
                            n_partitions: int):
    """One wave of a lane batch in the flat-row form, plain PyTorch:
    ``core(prow [B, 13+5P], bw [B], f32 [B, 2P+9], i32 [B, 3], step0 [B])
    -> (f32', i32', done_at)``, the rows of
    :class:`repro_torch.core.tickstate.TickLayout` for ``n_partitions``
    (:func:`repro_torch.kernels.tick_loop.tick_wave_reference`:
    :func:`build_wave_core` on the unpacked rows).  On a card the waves go
    through the tick kernel instead (:func:`run_cuda_wave_groups`)."""
    from repro_torch.kernels import tick_loop as tl

    width = tickstate.TickLayout(n_partitions).params_size

    def core(prow, bw, f32, i32, step0):
        if prow.shape[-1] != width:
            raise ValueError(f"parameter rows of width {prow.shape[-1]}, the "
                             f"runner was built for {n_partitions} "
                             f"partitions ({width})")
        return tl.tick_wave_reference(controller, env, cpu, prow, bw, f32,
                                      i32, step0, wave_steps=wave_steps,
                                      dt=dt, ctrl_every=ctrl_every)

    return core


def run_cuda_wave_groups(waves):
    """A fleet wave's lane batches through the CUDA tick kernel's wave mode
    together: one launch per partition count among them (and per 60
    batches).  ``waves`` is a list of
    :class:`repro_torch.kernels.tick_loop.Wave`, tensors on one CUDA
    device; returns one ``(f32', i32', done_at)`` per batch, in order."""
    from repro_torch.kernels import tick_loop as tl

    return tl.tick_wave_grouped(waves)


# ------------------------------------------------------------ caches ------
#
# Runners are cached per (controller code, env code, cpu, shape...,
# executor) — the things that select the code a batch runs.  Building one is
# cheap (the CUDA library is built and loaded once per process by
# kernels.build); the cache keeps one closure per group and
# clear_runner_caches() drops them.

_RUNNERS: dict = {}


def clear_runner_caches() -> None:
    """Drop every cached runner (wave runners too)."""
    _RUNNERS.clear()


def runner_cache_sizes() -> dict[str, int]:
    """Cached runners, wave runners included (observability / leak
    tests)."""
    return {"runner": len(_RUNNERS)}


def get_runner(controller_code, env_code, cpu: CpuProfile, n_steps: int,
               dt: float, ctrl_every: int, executor: str, *,
               observe: bool = False):
    """Engine core for one (controller code, environment code, cpu, shape,
    executor, observe) group, cached.  ``executor`` must already be resolved
    (:func:`resolve_executor` with the batch's device and ``observe``)."""
    key = (controller_code, env_code, cpu, n_steps, dt, ctrl_every, executor,
           observe)
    if key not in _RUNNERS:
        _RUNNERS[key] = build_core(controller_code, env_code, cpu,
                                   n_steps=n_steps, dt=dt,
                                   ctrl_every=ctrl_every, executor=executor,
                                   observe=observe)
    return _RUNNERS[key]


def get_wave_runner(controller_code, env_code, cpu: CpuProfile,
                    wave_steps: int, dt: float, ctrl_every: int,
                    n_partitions: int):
    """Plain flat-row wave core (:func:`build_blocked_wave_core`) for one
    (controller code, environment code, cpu, wave shape, partition count)
    group, cached.  Lanes are independent, so a batch may carry drained
    filler lanes (zero rows): they are frozen from their first tick."""
    key = ("wave", controller_code, env_code, cpu, wave_steps, dt,
           ctrl_every, n_partitions)
    if key not in _RUNNERS:
        _RUNNERS[key] = build_blocked_wave_core(
            controller_code, env_code, cpu, wave_steps=wave_steps, dt=dt,
            ctrl_every=ctrl_every, n_partitions=n_partitions)
    return _RUNNERS[key]
