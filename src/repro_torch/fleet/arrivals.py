"""Arrival traces and streams: what arrives when, carrying what.

A **trace** is a tuple of :class:`TransferRequest` — plain frozen metadata;
all numeric state lives in the engine once the scheduler admits the
request.  Two constructors cover the workload classes the offline fleet
layer targets:

* :func:`poisson_trace` — synthetic open-loop arrivals (exponential
  inter-arrival gaps from a seeded generator, controllers/datasets cycled
  or sampled), the standard model for transfer-service workloads;
* :func:`replay_trace` — replayed historical logs (list of dicts, e.g.
  parsed from a JSON export), the GreenDataFlow/cross-layer-log setting.

Both are deterministic: the same inputs produce the same trace, and
``run_fleet`` is invariant to the *order* of the trace tuple (it sorts by
arrival time with a content tie-break), so shuffling a trace never changes
fleet totals.

A **stream** is the online analogue (the online fleet, a later slice of
the port): a plain Python generator yielding :class:`TransferRequest` in
nondecreasing ``arrival_s`` order, possibly unbounded.  Three adapters
mirror the trace constructors:

* :func:`poisson_stream` — unbounded open-loop Poisson arrivals (one rng
  draw group per item, so memory is O(1) regardless of length);
* :func:`diurnal_stream` — Poisson arrivals with a raised-cosine daily
  rate profile (thinning against the peak rate), the operator-scale
  day/night load shape;
* :func:`replay_stream` — any in-order iterable of requests (e.g. a
  sorted trace, or records parsed lazily from a log), validated for
  monotone arrivals as it is consumed.

Streams and traces draw from *different rng consumption orders*
(vectorized vs. per-item), so ``poisson_stream`` and ``poisson_trace``
with the same seed yield different (equally valid) workloads — the traces
are pinned by golden tests and must not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.types import NetworkProfile


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    """One transfer in a fleet trace.

    ``controller`` accepts anything ``repro_torch.api.as_controller`` does (a
    registry name, a Controller instance, a legacy SLA).  ``profile`` is the
    transfer's *path* (RTT, per-flow bandwidth cap, loss knee); the shared
    host NIC on top of it is the host's, and contention rescaling happens in
    the scheduler.  ``host`` pins the transfer to a pool index; ``None``
    lets the scheduler assign one.  ``total_s`` is the per-transfer budget
    (quantized up to a whole number of waves).  ``attempt`` counts
    restarts: 0 for a fresh arrival, incremented each time fault injection
    requeues the transfer (``repro_torch.fleet.admission.resume_request``).
    """

    arrival_s: float
    datasets: tuple
    controller: Any
    profile: NetworkProfile
    host: Optional[int] = None
    name: Optional[str] = None
    total_s: float = 3600.0
    attempt: int = 0

    def __post_init__(self):
        object.__setattr__(self, "datasets", tuple(self.datasets))
        if self.arrival_s < 0:
            raise ValueError(f"negative arrival_s: {self.arrival_s}")


def request_sort_key(req: TransferRequest) -> tuple:
    """Canonical ordering: arrival time, then the request's FULL content.

    The scheduler sorts the trace with this key so host assignment — and
    therefore every downstream number — is a function of what arrived when,
    not of the order the caller happened to build the list in.  Every field
    that can influence a result participates (full dataset shapes, the
    controller's repr — frozen dataclasses, so repr covers all hyper-
    parameters — the whole path profile, and the budget): requests that tie
    on every component are genuinely interchangeable, so their relative
    order cannot affect fleet totals.
    """
    ctrl = (req.controller.lower() if isinstance(req.controller, str)
            else repr(req.controller))
    return (req.arrival_s,
            req.name or "",
            ctrl,
            tuple((s.name, s.num_files, s.total_mb, s.avg_file_mb,
                   s.std_file_mb) for s in req.datasets),
            dataclasses.astuple(req.profile),
            req.total_s,
            -1 if req.host is None else req.host,
            req.attempt)


def poisson_trace(*, rate_per_s: float, n_transfers: int,
                  datasets: Sequence[tuple], controllers: Sequence[Any],
                  profile: NetworkProfile, seed: int = 0,
                  total_s: float = 3600.0,
                  name_prefix: str = "xfer") -> tuple[TransferRequest, ...]:
    """Open-loop Poisson arrivals: exponential gaps at ``rate_per_s``.

    ``datasets`` is a menu of dataset tuples and ``controllers`` a menu of
    controller specs; each arrival samples one of each uniformly from a
    ``np.random.default_rng(seed)`` stream, so the trace is a pure function
    of its arguments.
    """
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be positive, got {rate_per_s}")
    if n_transfers <= 0:
        raise ValueError(f"n_transfers must be positive, got {n_transfers}")
    datasets = tuple(tuple(d) for d in datasets)
    controllers = tuple(controllers)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n_transfers)
    arrivals = np.cumsum(gaps)
    ds_idx = rng.integers(0, len(datasets), size=n_transfers)
    ctrl_idx = rng.integers(0, len(controllers), size=n_transfers)
    width = len(str(n_transfers - 1))
    return tuple(
        TransferRequest(
            arrival_s=float(arrivals[i]),
            datasets=datasets[ds_idx[i]],
            controller=controllers[ctrl_idx[i]],
            profile=profile,
            name=f"{name_prefix}-{i:0{width}d}",
            total_s=total_s,
        )
        for i in range(n_transfers))


_REPLAY_FIELDS = {f.name for f in dataclasses.fields(TransferRequest)}


def replay_trace(records: Sequence[dict], *,
                 profile: Optional[NetworkProfile] = None,
                 ) -> tuple[TransferRequest, ...]:
    """Build a trace from historical-log records (dicts).

    Each record supplies :class:`TransferRequest` fields by name;
    ``profile`` fills in a default path profile for records without one.
    Unknown keys raise — silently dropping log columns is how replay
    studies go wrong.
    """
    out = []
    for i, rec in enumerate(records):
        unknown = set(rec) - _REPLAY_FIELDS
        if unknown:
            raise ValueError(
                f"record {i} has unknown fields {sorted(unknown)}")
        rec = dict(rec)
        if "profile" not in rec:
            if profile is None:
                raise ValueError(f"record {i} has no profile and no default "
                                 f"was given")
            rec["profile"] = profile
        out.append(TransferRequest(**rec))
    return tuple(out)


# ===================================================================== #
# Streams — unbounded, in-order generators for the online fleet loop.   #
# ===================================================================== #


def _sample_request(rng, t, i, width, datasets, controllers, profile,
                    total_s, name_prefix):
    return TransferRequest(
        arrival_s=float(t),
        datasets=datasets[int(rng.integers(0, len(datasets)))],
        controller=controllers[int(rng.integers(0, len(controllers)))],
        profile=profile,
        name=f"{name_prefix}-{i:0{width}d}",
        total_s=total_s,
    )


def poisson_stream(*, rate_per_s: float, datasets: Sequence[tuple],
                   controllers: Sequence[Any], profile: NetworkProfile,
                   seed: int = 0, n_transfers: Optional[int] = None,
                   total_s: float = 3600.0,
                   name_prefix: str = "xfer",
                   ) -> Iterator[TransferRequest]:
    """Unbounded open-loop Poisson arrival stream.

    The streaming sibling of :func:`poisson_trace`: exponential gaps at
    ``rate_per_s``, dataset and controller sampled per arrival from a
    ``np.random.default_rng(seed)`` stream.  Memory is O(1) — one rng draw
    group per yielded item, nothing materialized.  ``n_transfers`` bounds
    the stream for tests/benchmarks; ``None`` streams forever (bound the
    run with ``OnlineConfig.horizon_s`` instead).

    Note: per-item rng consumption differs from ``poisson_trace``'s
    vectorized draws, so the same seed yields a *different* workload than
    the trace constructor — both deterministic, not interchangeable.

    ``rate_per_s == 0`` is the empty stream (no arrivals ever), so rate
    sweeps can include the idle endpoint without special-casing.
    """
    if rate_per_s < 0:
        raise ValueError(f"rate_per_s must be >= 0, got {rate_per_s}")
    if rate_per_s == 0:
        return
    datasets = tuple(tuple(d) for d in datasets)
    controllers = tuple(controllers)
    rng = np.random.default_rng(seed)
    width = len(str(n_transfers - 1)) if n_transfers else 7
    t = 0.0
    i = 0
    while n_transfers is None or i < n_transfers:
        t += float(rng.exponential(1.0 / rate_per_s))
        yield _sample_request(rng, t, i, width, datasets, controllers,
                              profile, total_s, name_prefix)
        i += 1


def diurnal_stream(*, base_rate_per_s: float, peak_rate_per_s: float,
                   period_s: float, datasets: Sequence[tuple],
                   controllers: Sequence[Any], profile: NetworkProfile,
                   seed: int = 0, n_transfers: Optional[int] = None,
                   total_s: float = 3600.0,
                   name_prefix: str = "xfer",
                   ) -> Iterator[TransferRequest]:
    """Poisson arrivals with a raised-cosine diurnal rate profile.

    Instantaneous rate
    ``rate(t) = base + (peak - base) * 0.5 * (1 - cos(2*pi*t/period_s))``
    — troughs at multiples of ``period_s`` (night), crests halfway (day).
    Sampled by Lewis–Shedler thinning against ``peak_rate_per_s``:
    candidate arrivals are drawn at the peak rate and kept with probability
    ``rate(t)/peak``, which is exact for any bounded rate function and
    stays O(1) memory.  ``base == peak`` degenerates to a plain Poisson
    stream (flat profile, every candidate kept) and ``base == 0`` gives
    troughs with no arrivals at all — both valid endpoints of a diurnal
    sweep.
    """
    if not 0.0 <= base_rate_per_s <= peak_rate_per_s:
        raise ValueError(f"need 0 <= base <= peak, got base="
                         f"{base_rate_per_s}, peak={peak_rate_per_s}")
    if peak_rate_per_s <= 0:
        raise ValueError(f"peak_rate_per_s must be positive, got "
                         f"{peak_rate_per_s}")
    if period_s <= 0:
        raise ValueError(f"period_s must be positive, got {period_s}")
    datasets = tuple(tuple(d) for d in datasets)
    controllers = tuple(controllers)
    rng = np.random.default_rng(seed)
    width = len(str(n_transfers - 1)) if n_transfers else 7
    t = 0.0
    i = 0
    while n_transfers is None or i < n_transfers:
        # Thinning: draw at the envelope rate, accept at rate(t)/peak.
        t += float(rng.exponential(1.0 / peak_rate_per_s))
        rate = base_rate_per_s + (peak_rate_per_s - base_rate_per_s) * (
            0.5 * (1.0 - math.cos(2.0 * math.pi * t / period_s)))
        if float(rng.random()) * peak_rate_per_s > rate:
            continue
        yield _sample_request(rng, t, i, width, datasets, controllers,
                              profile, total_s, name_prefix)
        i += 1


def replay_stream(requests: Iterable[TransferRequest],
                  ) -> Iterator[TransferRequest]:
    """Adapt any in-order iterable of requests into a validated stream.

    Yields items unchanged, checking nondecreasing ``arrival_s`` as the
    stream is consumed — the online loop's admission clock only moves
    forward, so an out-of-order arrival would be silently starved instead
    of scheduled.  Feed it a sorted offline trace for online/offline
    parity runs, or a lazy log parser for replay at scale.
    """
    last = -math.inf
    for i, req in enumerate(requests):
        if req.arrival_s < last:
            raise ValueError(
                f"stream is not in arrival order: item {i} "
                f"({req.name!r}) arrives at {req.arrival_s} after "
                f"{last}")
        last = req.arrival_s
        yield req
