"""Fault and churn injection for fleet runs: deterministic, seed-keyed (the
port of ``repro/workloads/faults.py``; host numpy, as there).

Production transfer fleets lose hosts mid-transfer, see NIC capacity sag
during maintenance windows, and kill/restart individual transfers.  A
:class:`FaultSchedule` describes all three as a frozen tuple of events:

* :class:`HostDown` — the host vanishes for ``[t0, t1)``: every lane on it
  is killed at the first wave boundary whose wave overlaps the outage, and
  admission to the host is blocked while any part of the coming wave
  overlaps it;
* :class:`NicDegrade` — the host's NIC capacity is multiplied by
  ``factor`` for waves overlapping ``[t0, t1)`` (transfers slow down via
  the shared contention rescale, nothing is killed);
* :class:`KillTransfer` — the named transfer is killed at the first wave
  boundary at or after ``t`` (a no-op if it is not in flight then).

Killed transfers re-enter the admission queue through the shared
``repro_torch.fleet.admission.resume_request`` path: under ``restart="resume"``
the requeued request carries only the partitions' *remaining* bytes (the
semantics ``repro_torch.ckpt`` restarts give training jobs — finished work is
kept); under ``restart="scratch"`` the full original request is requeued
and everything already moved is wasted.  Both fleet drivers
(``repro_torch.fleet.scheduler.run_fleet`` and
``repro_torch.fleet.online.run_fleet_online``) apply the schedule *between
waves*, at identical points of their loops, so the same seed produces
bit-identical reports offline and online.

The schedule is pure data: the drivers interrogate it with
:meth:`FaultSchedule.down_hosts` / :meth:`nic_caps` / :meth:`kills_in`
(all pure functions of simulated time) and account attempts through the
:class:`ChurnFold` it hands out — so ``repro_torch.fleet`` never imports
this package; any object with the same five methods injects faults.

:class:`ChurnFold` is the goodput-vs-throughput ledger.  Every attempt's
moved bytes are fed as their raw per-partition float32 components
(``offered`` positively, ``remaining`` negatively) into order-independent
:class:`repro_torch.fleet.aggregates.ExactSum` accumulators, so the telescoping
identity *offered == goodput* for a fully-completed resume-mode run holds
**bit-exactly**, independent of kill timing, wave order, or which driver
ran the fleet.  ``FaultSchedule.generate`` builds a random schedule from a
seed (per-host Poisson outage/degrade processes) that is a pure function
of its arguments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.fleet.aggregates import ExactSum

_RESTART_MODES = ("resume", "scratch")


@dataclasses.dataclass(frozen=True)
class HostDown:
    """Host ``host`` is lost for ``[t0, t1)`` seconds of simulated time."""

    host: int
    t0: float
    t1: float

    def __post_init__(self):
        if self.host < 0:
            raise ValueError(f"host must be >= 0, got {self.host}")
        if not self.t0 < self.t1:
            raise ValueError(f"need t0 < t1, got [{self.t0}, {self.t1})")


@dataclasses.dataclass(frozen=True)
class NicDegrade:
    """Host ``host``'s NIC runs at ``factor`` capacity for ``[t0, t1)``."""

    host: int
    t0: float
    t1: float
    factor: float = 0.5

    def __post_init__(self):
        if self.host < 0:
            raise ValueError(f"host must be >= 0, got {self.host}")
        if not self.t0 < self.t1:
            raise ValueError(f"need t0 < t1, got [{self.t0}, {self.t1})")
        if not 0.0 < self.factor <= 1.0:
            raise ValueError(f"factor must be in (0, 1], got {self.factor}")


@dataclasses.dataclass(frozen=True)
class KillTransfer:
    """The transfer named ``name`` is killed at time ``t``."""

    name: str
    t: float

    def __post_init__(self):
        if not self.name:
            raise ValueError("KillTransfer needs a transfer name")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A frozen, hashable fault plan plus the restart policy.

    ``events`` is any mix of :class:`HostDown` / :class:`NicDegrade` /
    :class:`KillTransfer`; ``restart`` selects the requeue semantics for
    killed transfers (``"resume"`` keeps finished bytes, ``"scratch"``
    re-offers the whole request).  The empty schedule is a bit-exact no-op:
    ``run_fleet(trace, hosts, faults=FaultSchedule())`` reproduces
    ``run_fleet(trace, hosts)`` per transfer (tested in
    tests/test_torch_workloads.py), with an all-zero churn block on top.
    """

    events: tuple = ()
    restart: str = "resume"

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for e in self.events:
            if not isinstance(e, (HostDown, NicDegrade, KillTransfer)):
                raise TypeError(f"unknown fault event {type(e).__name__}")
        if self.restart not in _RESTART_MODES:
            raise ValueError(f"restart must be one of {_RESTART_MODES}, "
                             f"got {self.restart!r}")

    # ------------------------------------------------- driver interface --

    def down_hosts(self, t0: float, t1: float) -> frozenset:
        """Hosts down at any point of the wave ``[t0, t1)``."""
        return frozenset(e.host for e in self.events
                         if isinstance(e, HostDown)
                         and e.t0 < t1 and e.t1 > t0)

    def nic_caps(self, hosts: Sequence, t0: float,
                 t1: float) -> Optional[list]:
        """Per-host NIC capacity (MB/s) for the wave ``[t0, t1)``, or None
        when no degrade window overlaps it.  Overlapping windows compound
        by taking the most degraded factor."""
        caps = None
        for e in self.events:
            if isinstance(e, NicDegrade) and e.t0 < t1 and e.t1 > t0:
                if e.host >= len(hosts):
                    continue
                if caps is None:
                    caps = [h.nic_mbps for h in hosts]
                caps[e.host] = min(caps[e.host],
                                   hosts[e.host].nic_mbps * e.factor)
        return caps

    def kills_in(self, t0: float, t1: float) -> frozenset:
        """Transfer names with a kill event in ``(t0, t1]`` — the drivers
        pass the previous and current wave boundaries, so every kill fires
        exactly once even across idle fast-forward jumps."""
        return frozenset(e.name for e in self.events
                         if isinstance(e, KillTransfer) and t0 < e.t <= t1)

    def churn_fold(self) -> "ChurnFold":
        """The attempt ledger a driver folds kills/retirements into."""
        return ChurnFold(restart=self.restart)

    # -------------------------------------------------------- generation --

    @staticmethod
    def generate(*, n_hosts: int, horizon_s: float, seed: int = 0,
                 host_loss_per_hour: float = 0.0,
                 outage_s: float = 120.0,
                 nic_degrade_per_hour: float = 0.0,
                 degrade_s: float = 300.0,
                 degrade_factor: float = 0.5,
                 restart: str = "resume") -> "FaultSchedule":
        """Seed-keyed random schedule: independent per-host Poisson
        processes of outages (rate ``host_loss_per_hour``, exponential
        duration ``outage_s``) and NIC-degrade windows (rate
        ``nic_degrade_per_hour``, duration ``degrade_s``, fixed
        ``degrade_factor``) over ``[0, horizon_s)``.  A pure function of
        its arguments — the same seed always yields the same schedule."""
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if horizon_s <= 0:
            raise ValueError(f"horizon_s must be positive, got {horizon_s}")
        rng = np.random.default_rng(seed)
        events: list = []
        for host in range(n_hosts):
            if host_loss_per_hour > 0.0:
                t = 0.0
                while True:
                    t += float(rng.exponential(3600.0 / host_loss_per_hour))
                    if t >= horizon_s:
                        break
                    dur = max(float(rng.exponential(outage_s)), 1.0)
                    events.append(HostDown(host, t, t + dur))
            if nic_degrade_per_hour > 0.0:
                t = 0.0
                while True:
                    t += float(rng.exponential(3600.0 / nic_degrade_per_hour))
                    if t >= horizon_s:
                        break
                    dur = max(float(rng.exponential(degrade_s)), 1.0)
                    events.append(
                        NicDegrade(host, t, t + dur, degrade_factor))
        return FaultSchedule(events=tuple(events), restart=restart)


class ChurnFold:
    """Goodput-vs-throughput ledger over every *attempt* a fleet ran.

    Each kill or retirement feeds the attempt's moved bytes as raw float32
    components — the offered per-partition totals positively, the leftover
    per-partition remainders negatively — into :class:`ExactSum`
    accumulators, one for goodput (attempts of transfers that eventually
    completed) and one for waste (killed-and-rescratched attempts, and
    transfers that never completed).  Because the exact sums are
    independent of accumulation order and the components telescope
    (``resume`` re-offers exactly the float32 remainders of the killed
    attempt), a fully-completed resume-mode run satisfies
    ``goodput_mb == offered_mb`` **bit-exactly** in either fleet driver.

    Memory is bounded: the only per-name state is ``_pending``, holding the
    killed attempts of transfers currently awaiting their final retirement
    — at most the in-flight + queued killed transfers, never the stream
    length.
    """

    __slots__ = ("restart", "kills", "host_loss_kills", "transfer_kills",
                 "restarts", "retired", "completed", "_offered", "_good",
                 "_good_j", "_wasted", "_wasted_j", "_energy", "_pending")

    def __init__(self, restart: str = "resume"):
        if restart not in _RESTART_MODES:
            raise ValueError(f"restart must be one of {_RESTART_MODES}, "
                             f"got {restart!r}")
        self.restart = restart
        self.kills = 0
        self.host_loss_kills = 0
        self.transfer_kills = 0
        self.restarts = 0
        self.retired = 0
        self.completed = 0
        self._offered = ExactSum()
        self._good = ExactSum()
        self._good_j = ExactSum()
        self._wasted = ExactSum()
        self._wasted_j = ExactSum()
        self._energy = ExactSum()
        self._pending: dict = {}   # name -> [(offered, remaining, J), ...]

    # ------------------------------------------------------------ events --

    @staticmethod
    def _add_parts(acc: ExactSum, offered_parts, remaining_parts) -> None:
        for x in np.asarray(offered_parts, np.float64).ravel():
            acc.add(x)
        for x in np.asarray(remaining_parts, np.float64).ravel():
            acc.add(-x)

    def kill(self, name: str, *, kind: str, attempt: int, offered_parts,
             remaining_parts, energy_j: float, requeued: bool) -> None:
        """One lane killed mid-flight.  ``kind`` is ``"host"`` (host loss)
        or ``"kill"`` (named kill); ``offered_parts``/``remaining_parts``
        are the attempt's per-partition float32 totals and leftovers."""
        self.kills += 1
        if kind == "host":
            self.host_loss_kills += 1
        else:
            self.transfer_kills += 1
        if attempt == 0:
            for x in np.asarray(offered_parts, np.float64).ravel():
                self._offered.add(x)
        self._energy.add(energy_j)
        if requeued:
            self.restarts += 1
        if self.restart == "scratch" or not requeued:
            # Scratch re-offers the whole request: this attempt's bytes are
            # definitively re-transferred, i.e. wasted.
            self._add_parts(self._wasted, offered_parts, remaining_parts)
            self._wasted_j.add(energy_j)
        else:
            # Resume: classification waits for the final retirement — the
            # bytes are goodput iff the transfer eventually completes.
            self._pending.setdefault(name, []).append(
                (np.asarray(offered_parts, np.float64).ravel().copy(),
                 np.asarray(remaining_parts, np.float64).ravel().copy(),
                 float(energy_j)))

    def retire(self, name: str, *, attempt: int, completed: bool,
               offered_parts, remaining_parts, energy_j: float) -> None:
        """One lane retired (drained, budget-exhausted, or horizon-cut)."""
        self.retired += 1
        self.completed += bool(completed)
        if attempt == 0:
            for x in np.asarray(offered_parts, np.float64).ravel():
                self._offered.add(x)
        self._energy.add(energy_j)
        acc, acc_j = ((self._good, self._good_j) if completed
                      else (self._wasted, self._wasted_j))
        for off, rem, kj in self._pending.pop(name, ()):
            self._add_parts(acc, off, rem)
            acc_j.add(kj)
        self._add_parts(acc, offered_parts, remaining_parts)
        acc_j.add(energy_j)

    def finalize(self) -> None:
        """Resolve attempts whose requeued transfer never ran again (e.g.
        a horizon cut with the request still queued): their bytes are
        wasted."""
        for name in list(self._pending):
            for off, rem, kj in self._pending.pop(name):
                self._add_parts(self._wasted, off, rem)
                self._wasted_j.add(kj)

    # ------------------------------------------------------------ report --

    def report(self) -> dict:
        good = self._good.value()
        wasted = self._wasted.value()
        # Exactly rounded sum over the union of both partial lists — the
        # true total of every classified component, immune to the 1-ulp
        # drift of adding two separately rounded sums.
        throughput = math.fsum(self._good._partials
                               + self._wasted._partials)
        return {
            "restart": self.restart,
            "kills": self.kills,
            "host_loss_kills": self.host_loss_kills,
            "transfer_kills": self.transfer_kills,
            "restarts": self.restarts,
            "retired": self.retired,
            "completed": self.completed,
            "offered_mb": self._offered.value(),
            "throughput_mb": throughput,
            "goodput_mb": good,
            "wasted_mb": wasted,
            "energy_j": self._energy.value(),
            "goodput_j": self._good_j.value(),
            "wasted_j": self._wasted_j.value(),
            "goodput_frac": good / max(throughput, 1e-9),
        }
