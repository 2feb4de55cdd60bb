"""Scenario: one declarative transfer experiment; run one, or sweep a grid.

``sweep`` is the headline: it groups scenarios whose code path is identical
(same controller code, environment code, CPU model, step count, tick stride,
partition count and executor), stacks each group's numeric inputs along a
leading lane axis, and runs each group as ONE lane batch.  On a CUDA device
one launch of the tick-loop kernel runs every group that shares a partition
count (groups that differ in it alone are already padded to one, as the JAX
package pads them), so a 72-cell figure grid is one launch instead of 72,
and each lane stops as soon as its transfer has drained.

Entry points run on the CUDA device unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and without a card they raise instead of
moving to the CPU.  ``device="cpu"`` runs the plain PyTorch tick loop.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import ScanInputs, TransferResult
from repro_torch.core.types import CpuProfile, NetworkProfile, TickMetrics

from .controllers import Controller, as_controller
from .environments import Environment, as_environment


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """Everything one transfer experiment needs, bundled and frozen.

    ``controller`` accepts anything :func:`as_controller` does — a Controller
    instance, a registry name ("eemt", "wget/curl", ...), an SLA or a
    StaticController.  ``environment`` accepts anything
    :func:`as_environment` does (``None`` is the reference physics).

    ``total_s`` is a *budget*, not a cost: the engine freezes all accounting
    at the completion tick, so ``energy_j`` / ``time_s`` / ``avg_power_w`` of
    a completed transfer are invariant to how generous the horizon was.

    ``executor`` selects the engine lowering (``repro_torch.core.engine``):
    ``"auto"`` resolves per device (``cuda`` on a card, ``reference`` on the
    CPU), and every executor is bit-identical.  It joins the sweep group key.

    ``eq=False``: scenarios may carry an ndarray ``bw_schedule``, so equality
    and hashing are by identity.
    """

    profile: NetworkProfile
    datasets: tuple
    controller: Any
    cpu: CpuProfile = CpuProfile()
    environment: Optional[Any] = None   # None -> reference physics
    total_s: float = 3600.0
    dt: float = 0.1
    bw_schedule: Optional[Any] = None   # [n_steps] fraction of bandwidth
    name: Optional[str] = None
    executor: str = "auto"              # engine lowering

    def __post_init__(self):
        object.__setattr__(self, "datasets", tuple(self.datasets))
        if not self.datasets:
            raise ValueError("Scenario needs at least one dataset")
        if not self.dt > 0.0:
            raise ValueError(f"dt must be positive, got {self.dt}")
        if self.total_s < self.dt:
            raise ValueError(f"total_s ({self.total_s}) must cover at least "
                             f"one tick of dt ({self.dt})")
        engine.resolve_executor(self.executor)   # validate the name


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.  A CUDA
    device without a card raises — nothing moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class _GroupKey(NamedTuple):
    """Lane-batch group key: everything that selects the code a batch runs."""

    ctrl_code: Controller
    env_code: Environment
    cpu: CpuProfile
    n_steps: int
    dt: float
    ctrl_every: int
    n_partitions: int
    executor: str


def ctrl_stride(ctrl: Controller, dt: float) -> int:
    """Engine ticks between controller invocations (the "Timeout" stride)."""
    return max(int(round(ctrl.timeout_s / dt)), 1) if ctrl.tunes else 1


def _group_key(ctrl: Controller, env: Environment, sc: Scenario,
               n_partitions: int, device) -> _GroupKey:
    """Single source of truth for both ``_prepare`` (actual grouping) and
    ``group_count`` (prediction)."""
    n_steps = int(round(sc.total_s / sc.dt))
    return _GroupKey(ctrl.code(), env.code(), sc.cpu, n_steps, sc.dt,
                     ctrl_stride(ctrl, sc.dt), n_partitions,
                     engine.resolve_executor(sc.executor, device))


class _Prepared(NamedTuple):
    key: _GroupKey
    inputs: ScanInputs      # numeric NamedTuple (numpy leaves)
    name: str
    total_s: float
    dt: float


def _np_tree(fn, *trees):
    """Apply ``fn`` leafwise across NamedTuples of numpy leaves."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_np_tree(fn, *xs) for xs in zip(*trees)])
    return fn(*trees)


def _prepare(sc: Scenario, device) -> _Prepared:
    ctrl: Controller = as_controller(sc.controller)
    env = as_environment(sc.environment)
    ci = ctrl.init(sc.datasets, sc.profile, sc.cpu)
    key = _group_key(ctrl, env, sc, len(ci.specs), device)
    n_steps = key.n_steps

    inputs = ScanInputs.from_init(ci, sc.profile, n_steps)
    if sc.bw_schedule is not None:
        bw = np.asarray(sc.bw_schedule, np.float32)
        if bw.shape != (n_steps,):
            raise ValueError(f"bw_schedule shape {bw.shape} != ({n_steps},)")
        inputs = inputs._replace(bw=bw)
    inputs = _np_tree(np.asarray, inputs)
    return _Prepared(key=key, inputs=inputs,
                     name=sc.name or ctrl.name,
                     total_s=sc.total_s, dt=sc.dt)


def _postprocess(sim, metrics, prep: _Prepared) -> TransferResult:
    """One lane's numpy SimState + traces -> TransferResult (host floats)."""
    completed = bool(np.sum(sim.remaining_mb) <= 0.0)
    if completed:
        # ``done[i]`` is recorded post-step: the transfer drained DURING tick
        # i, i.e. at time (i + 1) * dt.
        t_done = float(prep.dt * (int(np.argmax(metrics.done)) + 1))
    else:
        t_done = float(prep.total_s)
    energy = float(sim.energy_j)
    moved = float(sim.bytes_moved)
    avg_tput = moved / max(t_done, 1e-9)
    avg_power = energy / max(t_done, 1e-9)
    return TransferResult(
        name=prep.name,
        time_s=t_done,
        energy_j=energy,
        avg_tput_MBps=avg_tput,
        avg_tput_gbps=avg_tput * 8.0 / 1000.0,
        avg_power_w=avg_power,
        completed=completed,
        metrics=metrics,
    )


# ScanInputs leaves with a trailing partition axis.
_PARTITION_FIELDS = ("pp", "par", "total_mb", "avg_file_mb", "static_w")


def pad_partition_inputs(inputs: ScanInputs,
                         n_partitions: int) -> ScanInputs:
    """Widen ``ScanInputs`` to ``n_partitions`` with zero-byte partitions.

    A zero-byte partition is born drained: it gets no channels, contributes
    zero demand/bytes/energy, and the contention estimate averages over
    active partitions only — so padding is a bit-exact no-op on the results.
    """
    p = len(np.asarray(inputs.total_mb))
    if p == n_partitions:
        return inputs
    if p > n_partitions:
        raise ValueError(f"cannot shrink {p} partitions to {n_partitions}")
    pad = n_partitions - p
    return inputs._replace(**{
        f: np.concatenate([np.asarray(getattr(inputs, f)),
                           np.zeros(pad, np.float32)])
        for f in _PARTITION_FIELDS})


def _pad_partitions(prep: _Prepared, n_partitions: int) -> _Prepared:
    if prep.key.n_partitions == n_partitions:
        return prep
    return prep._replace(
        key=prep.key._replace(n_partitions=n_partitions),
        inputs=pad_partition_inputs(prep.inputs, n_partitions))


def _merged_partition_counts(keys) -> dict:
    """The padding policy shared by ``sweep`` and ``group_count``: each key
    is widened to the maximum partition count among the keys it could share
    a batch with (same key modulo partition count)."""
    p_max: dict[_GroupKey, int] = {}
    for k in keys:
        base = k._replace(n_partitions=0)
        p_max[base] = max(p_max.get(base, 0), k.n_partitions)
    return {k: p_max[k._replace(n_partitions=0)] for k in keys}


class GroupRun(NamedTuple):
    """One executed lane batch of a sweep: its key, the input positions of
    its lanes, and the engine's outputs as tensors on the device."""

    key: _GroupKey
    indices: list
    sim: Any                 # SimState, [B]-leading tensors
    ts: Any                  # TunerState
    metrics: TickMetrics     # [B, n_steps] each


def _prepare_groups(scenarios, device):
    prepared = [_prepare(sc, device) for sc in scenarios]
    # Merge across dataset counts: pad each scenario to the widest partition
    # axis among the scenarios it could share a batch with.
    merged = _merged_partition_counts([p.key for p in prepared])
    prepared = [_pad_partitions(p, merged[p.key]) for p in prepared]
    groups: dict[_GroupKey, list[int]] = defaultdict(list)
    for i, prep in enumerate(prepared):
        groups[prep.key].append(i)
    return prepared, groups


def _stack_group(prepared, idxs, device) -> ScanInputs:
    """The lane batch of one group: inputs stacked and moved to ``device``."""
    stacked = _np_tree(lambda *xs: np.stack(xs),
                       *[prepared[i].inputs for i in idxs])
    return _np_tree(lambda x: torch.as_tensor(x).to(device), stacked)


def run_groups(scenarios: Sequence[Scenario], *,
               device=None) -> tuple[list, list[GroupRun]]:
    """Prepare, group and execute ``scenarios``; returns the prepared
    scenarios and one :class:`GroupRun` per lane batch (outputs left on the
    device — :func:`sweep` post-processes them).

    The groups on the ``cuda`` executor run together
    (:func:`repro_torch.core.engine.run_cuda_groups`: one launch per
    partition count among them); every other executor's run one by one."""
    dev = resolve_device(device)
    prepared, groups = _prepare_groups(scenarios, dev)
    cuda = [key for key in groups if key.executor == "cuda"]
    outs = dict(zip(cuda, engine.run_cuda_groups([
        (key.ctrl_code, key.env_code, key.cpu, key.dt, key.ctrl_every,
         _stack_group(prepared, groups[key], dev)) for key in cuda])))
    runs = []
    for key, idxs in groups.items():
        if key not in outs:
            core = engine.get_runner(key.ctrl_code, key.env_code, key.cpu,
                                     key.n_steps, key.dt, key.ctrl_every,
                                     key.executor)
            outs[key] = core(_stack_group(prepared, idxs, dev))
        runs.append(GroupRun(key, idxs, *outs[key]))
    return prepared, runs


def _host(x):
    return x.contiguous().cpu().numpy()


def sweep(scenarios: Sequence[Scenario], *,
          device=None) -> list[TransferResult]:
    """Run many scenarios, batching shape-compatible ones into one lane
    batch (on a card, one kernel launch for all the groups of a partition
    count).  Results come back in input order, with numpy traces."""
    prepared, runs = run_groups(scenarios, device=device)
    results: list[Optional[TransferResult]] = [None] * len(prepared)
    for run_ in runs:
        sim = _np_tree(_host, run_.sim)
        metrics = _np_tree(_host, run_.metrics)
        for b, i in enumerate(run_.indices):
            results[i] = _postprocess(_np_tree(lambda x: x[b], sim),
                                      _np_tree(lambda x: x[b], metrics),
                                      prepared[i])
    return results


def run(scenario: Scenario, *, device=None) -> TransferResult:
    """Run one scenario to completion (or its ``total_s`` timeout)."""
    return sweep([scenario], device=device)[0]


def group_count(scenarios: Sequence[Scenario], *, device=None) -> int:
    """Number of lane batches (groups) a ``sweep`` over these on ``device``
    (default ``"cuda"``) would run: the JAX package's executables.  On a
    card one launch runs all the groups of a partition count.

    Computes only the group keys — no controller ``init`` or input arrays —
    and mirrors ``sweep``'s partition padding.  Needs no card.
    """
    dev = torch.device("cuda" if device is None else device)
    keys = [_group_key(as_controller(sc.controller),
                       as_environment(sc.environment), sc,
                       len(sc.datasets), dev)
            for sc in scenarios]
    merged = _merged_partition_counts(keys)
    return len({k._replace(n_partitions=merged[k]) for k in keys})
