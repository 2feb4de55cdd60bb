"""Admission and rescale logic of the fleet.

``repro_torch.fleet.scheduler.run_fleet`` (whole-trace, offline) makes its
scheduling decisions through these functions, as the JAX package's
offline and online loops share them (the online loop is a later slice of
the port):

* :class:`Combo` — prepared admission state for one unique
  (controller, datasets, profile, cpu, environment) combination: the packed
  flat parameter row and tick-0 state rows every admission of that
  combination shares;
* :func:`combo_key` — the dict key identifying a combination (hashable
  controller spelling, full dataset/profile content, host cpu+environment);
* :func:`pick_host` — the host-assignment policy (pinned, least-loaded, or
  round-robin, subject to per-host transfer-slot budgets);
* :func:`nic_shares` — the per-host proportional bandwidth rescale applied
  when in-flight demand exceeds a host's NIC;
* :func:`budget_steps` — the per-transfer tick budget (``total_s``
  quantized to whole ticks);
* :func:`make_transfer` — the retirement record (completion test, duration,
  frozen energy/bytes counters) read off a lane's flat f32 state row;
* :func:`resume_request` — the requeue spec for a lane killed by fault
  injection: under ``restart="resume"`` the new request re-offers exactly
  the per-partition float32 remainders read off the killed lane's state
  row (so byte conservation telescopes bit-exactly), under
  ``restart="scratch"`` the original datasets.

Everything here is host numpy: the lane rows live on the host between
waves, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.controllers import as_controller
from repro_torch.api.environments import as_environment
from repro_torch.api.scenario import ctrl_stride, pad_partition_inputs
from repro_torch.core import tickstate
from repro_torch.core.engine import ScanInputs
from repro_torch.tree import tree_map

from .aggregates import FleetTransfer
from .arrivals import TransferRequest
from .hosts import Host


def _host_rows(*tensors):
    return tuple(t.numpy() for t in tensors)


class Combo:
    """Prepared admission state for one unique
    (controller, datasets, profile, cpu, environment) combination.

    Built once per combination and shared across every admission of it —
    menu-based traces prepare dozens of combos, not thousands.  The flat
    rows (``params_row``, ``f0``, ``i0``; host numpy) follow
    :class:`repro_torch.core.tickstate.TickLayout` and are packed by
    :meth:`finalize` once the fleet-wide partition count is known.
    """

    __slots__ = ("inputs", "state0", "params_row", "f0", "i0", "key",
                 "ctrl_name", "env", "n_partitions", "ideal_s", "specs",
                 "offered_parts")

    def __init__(self, req: TransferRequest, host: Host, dt: float):
        ctrl = as_controller(req.controller)
        env = as_environment(host.environment)
        ci = ctrl.init(req.datasets, req.profile, host.cpu)
        inputs = ScanInputs.from_init(ci, req.profile, 1)
        # Scalar bandwidth share (the wave hook) instead of the [n_steps]
        # schedule single-scenario runs use.
        inputs = inputs._replace(bw=np.float32(1.0))
        self.inputs = tree_map(np.asarray, inputs)
        self.state0 = tree_map(np.asarray, ci.state)
        self.params_row = None         # set by finalize()
        self.f0 = None
        self.i0 = None
        self.env = env
        self.key = (ctrl.code(), env.code(), host.cpu,
                    ctrl_stride(ctrl, dt))
        self.ctrl_name = ctrl.name
        self.n_partitions = len(ci.specs)
        # The controller's partition specs and their float32 offered bytes
        # (as packed into the state row) — what resume_request and a churn
        # ledger read at kill/retire time.
        self.specs = tuple(ci.specs)
        self.offered_parts = np.asarray(self.inputs.total_mb,
                                        np.float32).ravel().copy()
        total_mb = float(np.sum(self.inputs.total_mb))
        self.ideal_s = total_mb / max(req.profile.bandwidth_mbps, 1e-9)

    def finalize(self, n_partitions: int) -> None:
        """Widen to the fleet-wide partition count and pack the flat
        admission rows: the shared parameter row plus the tick-0 state rows
        (through the environment's NetworkModel), packed on the CPU and
        kept as host numpy — one pack per combo, shared by every admission
        of it."""
        self.inputs = pad_partition_inputs(self.inputs, n_partitions)
        lay = tickstate.TickLayout(n_partitions)
        inp = tree_map(torch.as_tensor, self.inputs)
        sim0 = self.env.network.init_state(inp.total_mb, inp.net)
        ts0 = tree_map(torch.as_tensor, self.state0)
        (self.params_row,) = _host_rows(lay.pack_params(inp))
        self.f0, self.i0 = _host_rows(*lay.pack_state(sim0, ts0))


def combo_key(req: TransferRequest, host: Host) -> tuple:
    """Dict key identifying a :class:`Combo`: string controller spellings
    stay strings (cheap), anything else is normalized through
    ``as_controller`` so equivalent specs share one prepared combo."""
    return (req.controller if isinstance(req.controller, str)
            else as_controller(req.controller),
            req.datasets, req.profile, host.cpu,
            as_environment(host.environment))


def pick_host(req: TransferRequest, hosts: Sequence[Host],
              active: Sequence[int], assignment: str,
              rr: list, down: frozenset = frozenset()) -> Optional[int]:
    """Host index for an admission, or None when no slot is free.

    ``down`` is the set of host indices currently lost to fault injection
    (a ``FaultSchedule``'s ``down_hosts``): they accept no admissions, and a
    request pinned to a down host waits in the queue until it returns.
    """
    def free(i):
        return (i not in down
                and (hosts[i].slots == 0 or active[i] < hosts[i].slots))

    if req.host is not None:
        if not 0 <= req.host < len(hosts):
            raise ValueError(f"request {req.name!r} pinned to host "
                             f"{req.host}, pool has {len(hosts)}")
        return req.host if free(req.host) else None
    if assignment == "least-loaded":
        order = sorted(range(len(hosts)), key=lambda i: (active[i], i))
    elif assignment == "round-robin":
        order = [(rr[0] + k) % len(hosts) for k in range(len(hosts))]
    else:
        raise ValueError(f"unknown assignment policy {assignment!r}")
    for i in order:
        if free(i):
            if assignment == "round-robin":
                rr[0] = (i + 1) % len(hosts)
            return i
    return None


def nic_shares(hosts: Sequence[Host], demand: Sequence[float],
               caps: Optional[Sequence[float]] = None) -> list:
    """Per-host NIC contention: proportional rescale when the per-flow
    demands of a host's in-flight transfers exceed its NIC.  ``caps``
    overrides the per-host NIC capacity (fault-injected degrade windows,
    a ``FaultSchedule``'s ``nic_caps``); None keeps the hosts' nominal
    NICs."""
    if caps is None:
        caps = [h.nic_mbps for h in hosts]
    return [min(1.0, caps[i] / d) if d > 0 else 1.0
            for i, d in enumerate(demand)]


def budget_steps(req: TransferRequest, dt: float) -> int:
    """Per-transfer tick budget: ``total_s`` quantized to whole ticks (at
    least one)."""
    return max(int(round(req.total_s / dt)), 1)


def make_transfer(lay: tickstate.TickLayout, f32, *, name: str,
                  controller: str, host: str, arrival_s: float,
                  start_s: float, steps_done: int, done_at: int, dt: float,
                  ideal_s: float) -> FleetTransfer:
    """Retirement record for one lane, read off its flat f32 state row.

    Completion comes from the frozen remaining-bytes prefix; a completed
    transfer's duration is ``(done_at + 1) * dt`` (``done`` is recorded
    post-step — see the engine docstring), an incomplete one ran its whole
    ``steps_done`` budget.
    """
    completed = lay.remaining_sum(f32) <= 0.0
    if completed:
        time_s = float(dt * (done_at + 1))
    else:
        time_s = float(dt * steps_done)
    return FleetTransfer(
        name=name,
        controller=controller,
        host=host,
        arrival_s=arrival_s,
        start_s=start_s,
        time_s=time_s,
        energy_j=lay.energy_j(f32),
        moved_mb=lay.bytes_moved(f32),
        completed=completed,
        ideal_s=ideal_s,
    )


def resume_request(req: TransferRequest, name: str, specs,
                   remaining, *, restart: str) -> Optional[TransferRequest]:
    """Requeue spec for a lane killed by fault injection, or None when
    nothing remains to transfer.

    ``specs`` are the killed lane's partition specs (``Combo.specs`` — the
    controller's chunking, not the raw request datasets) and ``remaining``
    the per-partition float32 leftovers read off its state row.  Under
    ``restart="resume"`` the new request carries one dataset per partition
    with bytes left, each offering *exactly* the float32 remainder — the
    engine re-packs ``total_mb`` through float32, so the value round-trips
    unchanged and byte conservation telescopes bit-exactly.  Under
    ``restart="scratch"`` the original datasets are re-offered whole.

    Either way the requeued request keeps the original ``arrival_s`` (so
    its eventual response time spans the restart — restarts hurt latency
    SLOs, as they should), the resolved ``name`` (kill events target it),
    the controller, the budget, and any host pin; ``attempt`` increments.
    """
    if restart == "scratch":
        return dataclasses.replace(req, name=name, attempt=req.attempt + 1)
    remaining = np.asarray(remaining, np.float32).ravel()
    out = []
    for spec, rem in zip(specs, remaining):
        rem = float(rem)
        if rem <= 0.0:
            continue
        files = max(1, int(math.ceil(rem / max(spec.avg_file_mb, 1e-9))))
        out.append(dataclasses.replace(spec, num_files=files, total_mb=rem))
    if not out:
        return None
    return dataclasses.replace(req, name=name, datasets=tuple(out),
                               attempt=req.attempt + 1)
