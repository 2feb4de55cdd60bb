"""Fleet-level result records and aggregate metrics.

Per-transfer observables come straight from the engine's frozen final state
(energy integrated over the transfer only — completion masking), plus the
scheduler's queueing bookkeeping (admission wait).  Aggregates follow the
serving-systems conventions:

* **joules/GB** — total transfer-attributed energy over total bytes moved;
  the fleet analogue of the paper's per-transfer energy axis.
* **slowdown** — response time (queue wait + transfer duration) over the
  transfer's ideal solo network time ``bytes / path_bandwidth``; 1.0 is a
  perfectly scheduled, network-bound transfer, and p50/p95/p99 over the
  fleet expose the contention tail.
* **host utilization** — per host, the fraction of simulated waves with at
  least one in-flight transfer (busy fraction) and bytes moved over NIC
  capacity x busy time (NIC utilization).
"""
from __future__ import annotations

import dataclasses
import json
import math
from collections import defaultdict
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class FleetTransfer:
    """Outcome of one transfer inside a fleet run."""

    name: str
    controller: str
    host: str
    arrival_s: float
    start_s: float                  # admission time (>= arrival_s)
    time_s: float                   # transfer duration (excludes queue wait)
    energy_j: float
    moved_mb: float
    completed: bool
    ideal_s: float                  # solo network-bound lower bound

    @property
    def wait_s(self) -> float:
        return self.start_s - self.arrival_s

    @property
    def response_s(self) -> float:
        return self.wait_s + self.time_s

    @property
    def slowdown(self) -> float:
        return self.response_s / max(self.ideal_s, 1e-9)


def _percentiles(values) -> dict:
    if len(values) == 0:
        # None, not NaN: json.dumps would emit the non-standard `NaN`
        # literal, making BENCH records unparseable by strict readers
        # exactly in the all-transfers-failed cases worth inspecting.
        return {"p50": None, "p95": None, "p99": None}
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)),
            "p99": float(np.percentile(v, 99))}


@dataclasses.dataclass(frozen=True)
class HostStats:
    """Per-host utilization over one fleet run."""

    name: str
    moved_mb: float
    busy_frac: float                # fraction of waves with >= 1 transfer
    nic_util: float                 # moved / (nic capacity x busy seconds)
    peak_active: int                # max concurrent transfers observed


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Everything a fleet run produced, with aggregate views.

    ``transfers`` preserves canonical admission order; numbers in the
    aggregate views are plain floats so the report serializes to JSON
    (``to_json``) for the BENCH_* perf-trajectory records.
    """

    transfers: tuple
    host_stats: tuple
    sim_s: float                    # simulated seconds until the fleet drained
    waves: int
    wave_s: float
    dt: float
    dropped: int = 0                # requests never admitted (horizon cut)
    slo_s: Optional[float] = None   # per-request latency SLO (None: untracked)
    churn: Optional[dict] = None    # ChurnFold.report() (None: no faults)

    # ------------------------------------------------------------ totals --

    @property
    def total_energy_j(self) -> float:
        # fsum, not sum: exact summation makes totals independent of
        # accumulation order, so the online loop (which folds transfers in
        # retirement order) reproduces these bit-for-bit.
        return math.fsum(t.energy_j for t in self.transfers)

    @property
    def total_gb(self) -> float:
        return math.fsum(t.moved_mb for t in self.transfers) / 1024.0

    @property
    def joules_per_gb(self) -> float:
        return self.total_energy_j / max(self.total_gb, 1e-9)

    @property
    def completed(self) -> int:
        return sum(t.completed for t in self.transfers)

    def slowdowns(self) -> dict:
        return _percentiles([t.slowdown for t in self.transfers
                             if t.completed])

    # ----------------------------------------------------- latency / SLO --

    def latencies(self) -> dict:
        """p50/p95/p99 of completed transfers' response time (queue wait +
        duration, spanning fault restarts)."""
        return _percentiles([t.response_s for t in self.transfers
                             if t.completed])

    def slo_violations(self) -> int:
        """Requests that missed the latency SLO.  A transfer that never
        completed violated it by definition — an unserved request is worse
        than a slow one, not invisible."""
        if self.slo_s is None:
            raise ValueError("no SLO configured (run with slo_s=...)")
        return sum(1 for t in self.transfers
                   if not t.completed or t.response_s > self.slo_s)

    def slo_violation_rate(self) -> float:
        return self.slo_violations() / max(len(self.transfers), 1)

    # ------------------------------------------------------- breakdowns --

    def by_controller(self) -> dict:
        """Per-controller aggregate rows (the fleet-scale comparison the
        single-transfer figure grids cannot make)."""
        groups: dict[str, list[FleetTransfer]] = defaultdict(list)
        for t in self.transfers:
            groups[t.controller].append(t)
        out = {}
        for name in sorted(groups):
            ts = groups[name]
            # fsum / fsum-mean: order-independent, so the online fold (in
            # retirement order) matches these bit-for-bit.
            gb = math.fsum(t.moved_mb for t in ts) / 1024.0
            energy = math.fsum(t.energy_j for t in ts)
            out[name] = {
                "transfers": len(ts),
                "completed": sum(t.completed for t in ts),
                "energy_j": float(energy),
                "gb": float(gb),
                "joules_per_gb": float(energy / max(gb, 1e-9)),
                "slowdown": _percentiles(
                    [t.slowdown for t in ts if t.completed]),
                "mean_time_s": math.fsum(t.time_s for t in ts) / len(ts),
                "mean_wait_s": math.fsum(t.wait_s for t in ts) / len(ts),
            }
        return out

    def summary(self) -> dict:
        out = {
            "transfers": len(self.transfers),
            "completed": self.completed,
            "dropped": self.dropped,
            "hosts": len(self.host_stats),
            "sim_s": self.sim_s,
            "waves": self.waves,
            "total_energy_j": self.total_energy_j,
            "total_gb": self.total_gb,
            "joules_per_gb": self.joules_per_gb,
            "slowdown": self.slowdowns(),
            "host_busy_frac": {h.name: h.busy_frac
                               for h in self.host_stats},
            "host_nic_util": {h.name: h.nic_util for h in self.host_stats},
            "by_controller": self.by_controller(),
        }
        # Additive blocks only — fault-free, SLO-free runs keep the exact
        # pre-workloads summary (golden-pinned in tests/test_fleet.py).
        if self.slo_s is not None:
            out["latency"] = self.latencies()
            out["slo"] = {"slo_s": self.slo_s,
                          "violations": self.slo_violations(),
                          "violation_rate": self.slo_violation_rate()}
        if self.churn is not None:
            out["churn"] = dict(self.churn)
        return out

    def to_json(self, path: Optional[str] = None, **extra) -> str:
        """Serialize ``summary()`` (+ caller extras, e.g. wall-clock) to
        JSON; writes to ``path`` when given."""
        payload = dict(self.summary(), **extra)
        text = json.dumps(payload, indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


# ===================================================================== #
# Streaming aggregation — the bounded-memory mirror of FleetReport.     #
# ===================================================================== #


class ExactSum:
    """Exactly rounded streaming sum (Shewchuk's adaptive partials).

    ``add`` maintains a list of non-overlapping partials whose exact sum is
    the exact sum of everything added; ``value`` rounds it once, via
    ``math.fsum`` over the partials.  The result is therefore *independent
    of accumulation order* — the property that lets the online loop, which
    folds transfers in retirement order, reproduce the offline
    ``math.fsum`` totals (taken in sorted-trace order) bit-for-bit.  The
    partials list stays tiny (its length is bounded by the exponent spread
    of the inputs, ~40 entries for fleet magnitudes), so memory is O(1).
    """

    __slots__ = ("_partials",)

    def __init__(self):
        self._partials: list[float] = []

    def add(self, x: float) -> None:
        # Standard error-free transformation: after the loop, partials are
        # non-overlapping and sum exactly to (old partials sum) + x.
        x = float(x)
        partials = self._partials
        i = 0
        for y in partials:
            if abs(x) < abs(y):
                x, y = y, x
            hi = x + y
            lo = y - (hi - x)
            if lo:
                partials[i] = lo
                i += 1
            x = hi
        partials[i:] = [x]

    def value(self) -> float:
        return math.fsum(self._partials)


class QuantileSketch:
    """Deterministic bounded-memory quantile sketch (DDSketch-style).

    Values land in geometric buckets ``gamma**k`` with
    ``gamma = (1 + rel_err) / (1 - rel_err)``; a quantile query returns the
    geometric midpoint of the bucket holding the target rank, which is
    within ``rel_err`` *relative* error of the true value for everything
    inside the clamp range ``[lo, hi]`` (values outside are clamped into
    the boundary buckets).  The bucket array is fixed at construction —
    ~2.3k int64 counts at the defaults — so memory never grows with the
    stream, and the sketch is deterministic: the same multiset of values
    produces the same counts regardless of arrival order.

    This is the documented tolerance on online percentile parity: p50/p95/
    p99 from the sketch match ``np.percentile`` of the materialized values
    to within ``rel_err`` relative error (plus interpolation differences —
    ``np.percentile`` interpolates between order statistics, the sketch
    answers with a nearest-rank bucket midpoint).
    """

    __slots__ = ("rel_err", "gamma", "_log_gamma", "lo", "hi", "_kmin",
                 "counts", "n", "_zero")

    def __init__(self, rel_err: float = 0.01, lo: float = 1e-4,
                 hi: float = 1e8):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        if not 0.0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self.gamma)
        self.lo = float(lo)
        self.hi = float(hi)
        self._kmin = math.floor(math.log(lo) / self._log_gamma)
        kmax = math.ceil(math.log(hi) / self._log_gamma)
        self.counts = np.zeros(kmax - self._kmin + 1, np.int64)
        self.n = 0
        self._zero = 0                  # values <= 0 (count-only bucket)

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if x <= 0.0:
            self._zero += 1
            return
        x = min(max(x, self.lo), self.hi)
        k = math.ceil(math.log(x) / self._log_gamma) - self._kmin
        self.counts[min(max(k, 0), len(self.counts) - 1)] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile, or None for an empty sketch."""
        if self.n == 0:
            return None
        rank = min(int(math.ceil(q * self.n)), self.n)
        if rank <= self._zero:
            return 0.0
        seen = self._zero
        for k, c in enumerate(self.counts):
            seen += int(c)
            if seen >= rank:
                # Geometric bucket midpoint: bucket k covers
                # (gamma**(k-1+kmin), gamma**(k+kmin)].
                return math.exp((k + self._kmin - 0.5) * self._log_gamma)
        return self.hi                   # unreachable (counts sum to n-zero)

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class _GroupFold:
    """Streaming per-group totals mirroring one ``by_controller()`` row."""

    __slots__ = ("transfers", "completed", "energy", "moved_mb", "time_s",
                 "wait_s", "slowdown")

    def __init__(self, rel_err: float):
        self.transfers = 0
        self.completed = 0
        self.energy = ExactSum()
        self.moved_mb = ExactSum()
        self.time_s = ExactSum()
        self.wait_s = ExactSum()
        self.slowdown = QuantileSketch(rel_err)

    def add(self, t: FleetTransfer) -> None:
        self.transfers += 1
        self.completed += t.completed
        self.energy.add(t.energy_j)
        self.moved_mb.add(t.moved_mb)
        self.time_s.add(t.time_s)
        self.wait_s.add(t.wait_s)
        if t.completed:
            self.slowdown.add(t.slowdown)

    def row(self) -> dict:
        gb = self.moved_mb.value() / 1024.0
        energy = self.energy.value()
        return {
            "transfers": self.transfers,
            "completed": self.completed,
            "energy_j": energy,
            "gb": gb,
            "joules_per_gb": energy / max(gb, 1e-9),
            "slowdown": self.slowdown.percentiles(),
            "mean_time_s": self.time_s.value() / max(self.transfers, 1),
            "mean_wait_s": self.wait_s.value() / max(self.transfers, 1),
        }


class FleetFold:
    """Incremental FleetReport: fold retirements one at a time, in any
    order, into O(1) state.

    Totals (energy, GB, joules/GB, per-controller sums and means) are
    *exact* — :class:`ExactSum` makes them independent of fold order, so
    they bit-match the offline ``FleetReport`` of the same transfers.
    Percentile fields come from :class:`QuantileSketch` and carry its
    documented ``rel_err`` relative-error tolerance instead.

    ``slo_s`` arms per-request latency SLO tracking: response-time
    percentiles stream through a latency sketch (same ``rel_err``
    tolerance vs the offline ``FleetReport.latencies()``), and the
    violation *count* — a transfer that missed the SLO or never completed
    — is an integer, bit-equal to the offline count.
    """

    def __init__(self, rel_err: float = 0.01,
                 slo_s: Optional[float] = None):
        self._total = _GroupFold(rel_err)
        self._by_ctrl: dict[str, _GroupFold] = {}
        self._rel_err = rel_err
        self.slo_s = slo_s
        self._latency = QuantileSketch(rel_err)
        self._violations = 0

    def add(self, t: FleetTransfer) -> None:
        self._total.add(t)
        if t.completed:
            self._latency.add(t.response_s)
        if self.slo_s is not None and (not t.completed
                                       or t.response_s > self.slo_s):
            self._violations += 1
        g = self._by_ctrl.get(t.controller)
        if g is None:
            g = self._by_ctrl[t.controller] = _GroupFold(self._rel_err)
        g.add(t)

    @property
    def transfers(self) -> int:
        return self._total.transfers

    @property
    def completed(self) -> int:
        return self._total.completed

    @property
    def total_energy_j(self) -> float:
        return self._total.energy.value()

    @property
    def total_gb(self) -> float:
        return self._total.moved_mb.value() / 1024.0

    def slowdowns(self) -> dict:
        return self._total.slowdown.percentiles()

    def latencies(self) -> dict:
        return self._latency.percentiles()

    def slo_violations(self) -> int:
        if self.slo_s is None:
            raise ValueError("no SLO configured (FleetFold(slo_s=...))")
        return self._violations

    def slo_violation_rate(self) -> float:
        return self.slo_violations() / max(self._total.transfers, 1)

    def by_controller(self) -> dict:
        return {name: self._by_ctrl[name].row()
                for name in sorted(self._by_ctrl)}


@dataclasses.dataclass(frozen=True)
class OnlineFleetReport:
    """What an online fleet run produced — ``FleetReport``'s bounded-memory
    sibling.

    ``summary()`` carries the same keys as :meth:`FleetReport.summary` (so
    BENCH records and downstream tables are drop-in) plus a ``"counters"``
    block of per-run observability totals from the wave loop.  There is no
    ``transfers`` tuple by default — aggregates were folded incrementally —
    but runs with ``track_transfers=True`` (a debug/parity knob that
    re-introduces O(n) memory) retain the per-transfer records, sorted by
    ``(start_s, name)``.
    """

    fold: FleetFold
    host_stats: tuple
    sim_s: float
    waves: int
    wave_s: float
    dt: float
    dropped: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    transfers: Optional[tuple] = None   # only when track_transfers=True
    churn: Optional[dict] = None        # ChurnFold.report() (None: no faults)

    @property
    def total_energy_j(self) -> float:
        return self.fold.total_energy_j

    @property
    def total_gb(self) -> float:
        return self.fold.total_gb

    @property
    def joules_per_gb(self) -> float:
        return self.total_energy_j / max(self.total_gb, 1e-9)

    @property
    def completed(self) -> int:
        return self.fold.completed

    def slowdowns(self) -> dict:
        return self.fold.slowdowns()

    @property
    def slo_s(self) -> Optional[float]:
        return self.fold.slo_s

    def latencies(self) -> dict:
        return self.fold.latencies()

    def slo_violations(self) -> int:
        return self.fold.slo_violations()

    def slo_violation_rate(self) -> float:
        return self.fold.slo_violation_rate()

    def by_controller(self) -> dict:
        return self.fold.by_controller()

    def summary(self) -> dict:
        out = {
            "transfers": self.fold.transfers,
            "completed": self.completed,
            "dropped": self.dropped,
            "hosts": len(self.host_stats),
            "sim_s": self.sim_s,
            "waves": self.waves,
            "total_energy_j": self.total_energy_j,
            "total_gb": self.total_gb,
            "joules_per_gb": self.joules_per_gb,
            "slowdown": self.slowdowns(),
            "host_busy_frac": {h.name: h.busy_frac
                               for h in self.host_stats},
            "host_nic_util": {h.name: h.nic_util for h in self.host_stats},
            "by_controller": self.by_controller(),
            "counters": dict(self.counters),
        }
        # Additive blocks, mirroring FleetReport.summary: latency
        # percentiles carry the sketch's rel_err tolerance, the violation
        # count is bit-exact.
        if self.slo_s is not None:
            out["latency"] = self.latencies()
            out["slo"] = {"slo_s": self.slo_s,
                          "violations": self.slo_violations(),
                          "violation_rate": self.slo_violation_rate()}
        if self.churn is not None:
            out["churn"] = dict(self.churn)
        return out

    def to_json(self, path: Optional[str] = None, **extra) -> str:
        payload = dict(self.summary(), **extra)
        text = json.dumps(payload, indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text
