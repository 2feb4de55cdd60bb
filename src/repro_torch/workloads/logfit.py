"""Fit simulator network parameters from historical per-transfer logs.

The PyTorch twin of the JAX package's ``repro.workloads.logfit``: the same
parsing and fitting (host numpy, copied as they are) and the same replay
physics.

1. :func:`load_transfer_log` parses a log — a CSV/JSON file path or an
   in-memory sequence of dicts — into frozen :class:`LogRecord` rows
   (``start_s``, ``end_s`` or ``duration_s``, ``mb``, optional ``rtt_s``).
   Unknown columns raise.
2. :func:`fit_network_log` bins the records onto a fixed ``bin_s`` grid
   (overlap-weighted) and aggregates each bin into one bandwidth estimate —
   ``"sum"`` (default: aggregate observed throughput), ``"max"`` (fastest
   single transfer) or ``"mean"`` (time-weighted mean per-transfer rate).
   Empty bins hold the previous estimate (leading empties backfill from the
   first observation).  The fitted RTT is the median of the records that
   carry one.
3. :class:`LogFitNetworkModel` replays the fitted schedule: each tick it
   looks up the bin of the lane's simulated time in a device table of the
   schedule, substitutes the fitted bandwidth (and RTT, when fitted) into
   the network parameters, and delegates to the reference step.  A
   constant schedule at the profile's nominal bandwidth, with no fitted
   RTT, is a bit-exact no-op.  The CUDA tick kernel reads the same table
   through a device pointer.

Registered as ``make_environment("logfit", log=...)`` (lazily, in
``repro_torch.api.environments``).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
from pathlib import Path
from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import network_model
from repro_torch.core._f32 import ftz
from repro_torch.core.tickstate import const_table
from repro_torch.core.types import SimState

_AGGS = ("sum", "max", "mean")
_RECORD_FIELDS = {"start_s", "end_s", "duration_s", "mb", "rtt_s"}


@dataclasses.dataclass(frozen=True)
class LogRecord:
    """One historical transfer: moved ``mb`` over ``[start_s, end_s)``."""

    start_s: float
    end_s: float
    mb: float
    rtt_s: Optional[float] = None

    def __post_init__(self):
        if self.start_s < 0:
            raise ValueError(f"negative start_s: {self.start_s}")
        if not self.end_s > self.start_s:
            raise ValueError(f"need end_s > start_s, got "
                             f"[{self.start_s}, {self.end_s})")
        if self.mb <= 0:
            raise ValueError(f"mb must be positive, got {self.mb}")
        if self.rtt_s is not None and self.rtt_s <= 0:
            raise ValueError(f"rtt_s must be positive, got {self.rtt_s}")

    @property
    def rate_mbps(self) -> float:
        return self.mb / (self.end_s - self.start_s)


def _coerce_record(i: int, rec: dict) -> LogRecord:
    unknown = set(rec) - _RECORD_FIELDS
    if unknown:
        raise ValueError(f"log record {i} has unknown fields "
                         f"{sorted(unknown)} (known: "
                         f"{sorted(_RECORD_FIELDS)})")
    if "mb" not in rec or "start_s" not in rec:
        raise ValueError(f"log record {i} needs 'start_s' and 'mb'")
    start = float(rec["start_s"])
    if "end_s" in rec and rec["end_s"] not in (None, ""):
        end = float(rec["end_s"])
    elif "duration_s" in rec and rec["duration_s"] not in (None, ""):
        end = start + float(rec["duration_s"])
    else:
        raise ValueError(f"log record {i} needs 'end_s' or 'duration_s'")
    rtt = rec.get("rtt_s")
    rtt = float(rtt) if rtt not in (None, "") else None
    return LogRecord(start_s=start, end_s=end, mb=float(rec["mb"]),
                     rtt_s=rtt)


def load_transfer_log(log: Union[str, Path, Iterable[dict]],
                      ) -> tuple:
    """Parse a transfer log into a tuple of :class:`LogRecord`.

    ``log`` is a path to a ``.json`` file (a list of record objects), a
    path to a CSV file (header row naming the fields), or any in-memory
    iterable of dicts.  Every record needs ``start_s``, ``mb``, and one of
    ``end_s`` / ``duration_s``; ``rtt_s`` is optional.  Unknown fields
    raise.
    """
    if isinstance(log, (str, Path)):
        path = Path(log)
        if path.suffix.lower() == ".json":
            records = json.loads(path.read_text())
            if not isinstance(records, list):
                raise ValueError(f"{path}: expected a JSON list of records")
        else:
            with path.open(newline="") as fh:
                records = list(csv.DictReader(fh))
    else:
        records = list(log)
    if not records:
        raise ValueError("transfer log is empty")
    return tuple(_coerce_record(i, dict(rec))
                 for i, rec in enumerate(records))


@dataclasses.dataclass(frozen=True)
class LogFitNetworkModel:
    """Piecewise-constant fitted path: the reference WAN physics driven by
    a binned bandwidth schedule (and optional fitted RTT).

    ``bw_mbps[k]`` applies to simulated time ``[k * bin_s, (k+1) * bin_s)``
    and the last bin extends forever (transfers outliving the log see its
    final estimate).  Frozen and hashable — ``bw_mbps`` is a tuple — so it
    joins the sweep group key like any environment; each distinct schedule
    is its own lane batch.
    """

    name = "logfit"
    bin_s: float = 60.0
    bw_mbps: tuple = (1250.0,)
    rtt_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "bw_mbps",
                           tuple(float(b) for b in self.bw_mbps))
        if self.bin_s <= 0:
            raise ValueError(f"bin_s must be positive, got {self.bin_s}")
        if not self.bw_mbps:
            raise ValueError("bw_mbps schedule is empty")
        if any(b <= 0 for b in self.bw_mbps):
            raise ValueError(f"bw_mbps must be positive, got "
                             f"{self.bw_mbps}")
        if self.rtt_s is not None and self.rtt_s <= 0:
            raise ValueError(f"rtt_s must be positive, got {self.rtt_s}")

    def code(self) -> "LogFitNetworkModel":
        return self

    def init_state(self, total_mb, net) -> SimState:
        return network_model.init_state(total_mb, net)

    def step(self, energy, net, cpu, state, params, avg_file_mb, dt,
             bw_scale):
        t = state.t
        table = const_table(self.bw_mbps, t.device)
        # t / bin_s tensor by tensor: a division by a Python float is a
        # multiply by its reciprocal on CUDA.
        q = ftz(torch.div(t, torch.full_like(t, np.float32(self.bin_s))))
        idx = torch.floor(q).to(torch.int32).clamp(0, len(self.bw_mbps) - 1)
        net = net._replace(bandwidth_mbps=table[idx.long()])
        if self.rtt_s is not None:
            net = net._replace(
                rtt_s=torch.full_like(t, np.float32(self.rtt_s)))
        return network_model.step(net, cpu, state, params, avg_file_mb, dt,
                                  bw_scale, energy=energy)


def fit_network_log(records: Sequence[LogRecord], *, bin_s: float = 60.0,
                    agg: str = "sum") -> LogFitNetworkModel:
    """Fit a :class:`LogFitNetworkModel` to parsed log records.

    Each record contributes its mean rate to every ``bin_s`` bin it
    overlaps, weighted by the overlap duration; ``agg`` folds each bin's
    contributions into one bandwidth (see the module docstring).  Empty
    bins hold the previous estimate (leading empties backfill from the
    first non-empty bin).  The fitted RTT is the median over records that
    carry one, else ``None`` (keep the profile's nominal RTT).
    """
    if bin_s <= 0:
        raise ValueError(f"bin_s must be positive, got {bin_s}")
    if agg not in _AGGS:
        raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
    records = tuple(records)
    if not records:
        raise ValueError("no records to fit")
    horizon = max(r.end_s for r in records)
    n_bins = max(int(math.ceil(horizon / bin_s)), 1)
    weighted = np.zeros(n_bins)     # sum(rate * overlap_s) per bin
    overlap = np.zeros(n_bins)      # sum(overlap_s) per bin
    peak = np.zeros(n_bins)         # max single-transfer rate per bin
    for r in records:
        rate = r.rate_mbps
        b0 = int(r.start_s // bin_s)
        b1 = min(int(math.ceil(r.end_s / bin_s)), n_bins)
        for b in range(b0, b1):
            ov = min(r.end_s, (b + 1) * bin_s) - max(r.start_s, b * bin_s)
            if ov <= 0:
                continue
            weighted[b] += rate * ov
            overlap[b] += ov
            peak[b] = max(peak[b], rate)
    bw = np.zeros(n_bins)
    seen = overlap > 0
    if not seen.any():
        raise ValueError("no record overlaps any bin")  # unreachable
    if agg == "sum":
        bw[seen] = weighted[seen] / bin_s
    elif agg == "max":
        bw[seen] = peak[seen]
    else:
        bw[seen] = weighted[seen] / overlap[seen]
    # Hold-last fill for gaps; leading empties backfill from the first
    # observation so the schedule starts at a measured value.
    first = int(np.flatnonzero(seen)[0])
    bw[:first] = bw[first]
    for b in range(first + 1, n_bins):
        if not seen[b]:
            bw[b] = bw[b - 1]
    rtts = sorted(r.rtt_s for r in records if r.rtt_s is not None)
    rtt = float(np.median(rtts)) if rtts else None
    return LogFitNetworkModel(bin_s=float(bin_s), bw_mbps=tuple(bw),
                              rtt_s=rtt)


def logfit_environment(log=None, *, bin_s: float = 60.0, agg: str = "sum",
                       model: Optional[LogFitNetworkModel] = None):
    """Build an Environment around a fitted (or given) logfit model.

    Backs ``make_environment("logfit", log=..., bin_s=..., agg=...)``:
    ``log`` is anything :func:`load_transfer_log` accepts (or a sequence
    of :class:`LogRecord`); alternatively pass a prebuilt ``model``.
    With neither, the degenerate default fit — a constant schedule at the
    nominal bandwidth — keeps the registry's no-kwargs contract.
    """
    from repro_torch.api.environments import Environment

    if log is not None and model is not None:
        raise ValueError("pass at most one of log= or model=")
    if log is None and model is None:
        model = LogFitNetworkModel()
    elif model is None:
        records = load_transfer_log(log) if not (
            isinstance(log, (list, tuple)) and log
            and isinstance(log[0], LogRecord)) else tuple(log)
        model = fit_network_log(records, bin_s=bin_s, agg=agg)
    return Environment(network=model)
