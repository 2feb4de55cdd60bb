"""HTTP-service request workloads: many small transfers, warm connections
(the port of ``repro/workloads/http.py``; host numpy, as there).

Bulk traces (``repro_torch.fleet.arrivals``) model few large transfers; an
HTTP-style service is the opposite corner — a closed population of users
issuing streams of *small* requests with think time between them, where
connection handling dominates.  :func:`http_request_stream` renders that
workload as ordinary :class:`repro_torch.fleet.TransferRequest` items, so it
flows through both fleet drivers (and the tick kernel's wave mode)
unchanged:

* **Persistent connections.**  Each user holds one connection.  A request
  arriving within ``keepalive_s`` of the previous response reuses it
  (*warm*: the request payload only); a request after the keepalive window
  must re-establish it (*cold*: an extra ``conn_setup_mb`` startup
  partition modelling TCP+TLS handshake cost — the paper's startup
  overhead expressed in the simulator's only currency, bytes).  Setting
  ``keepalive_s=0`` disables reuse (every request cold), ``math.inf``
  makes only each user's first request cold.
* **Closed-loop arrivals.**  Users think, request, wait, think again: the
  next arrival follows the previous request's *estimated* service time
  (ideal time at the path's per-flow bandwidth — the stream is generated
  ahead of simulation, so actual completion times are unknowable here)
  plus an exponential think time.  Load self-regulates with service speed,
  the defining property of closed-loop workloads.
* **Per-request SLOs.**  A :class:`ServiceLevel` carries the latency
  objective; pass ``slo_s=service_level.latency_s`` to ``run_fleet`` /
  ``OnlineConfig`` to arm the per-request violation counter and latency
  quantile sketch in the fleet report, and judge the result with
  :meth:`ServiceLevel.evaluate`.

Determinism: every draw comes from per-user generators seeded
``np.random.default_rng([seed, user])``, and users merge through a heap
keyed (time, user) — the stream is a pure function of the
:class:`HttpService` spec.  Request payloads are drawn from a small
quantized size menu, not a continuum: the admission layer caches one
prepared :class:`repro_torch.fleet.admission.Combo` per unique dataset
tuple, so a bounded size menu keeps the online loop's memory bounded over
an unbounded stream.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.types import CHAMELEON, DatasetSpec, NetworkProfile
from repro_torch.fleet.arrivals import TransferRequest


@dataclasses.dataclass(frozen=True)
class ServiceLevel:
    """A per-request latency objective and its acceptable violation rate.

    ``latency_s`` is the response-time SLO every request is judged against
    (arrival to completion, queueing and restarts included);
    ``max_violation_rate`` is the fraction of requests allowed to miss it
    (the "99% of requests under 2 s" spelling: ``ServiceLevel(2.0, 0.01)``).
    """

    latency_s: float
    max_violation_rate: float = 0.05

    def __post_init__(self):
        if self.latency_s <= 0:
            raise ValueError(f"latency_s must be positive, got "
                             f"{self.latency_s}")
        if not 0.0 <= self.max_violation_rate <= 1.0:
            raise ValueError(f"max_violation_rate must be in [0, 1], got "
                             f"{self.max_violation_rate}")

    def evaluate(self, report) -> dict:
        """Judge a fleet report (offline or online, run with
        ``slo_s=self.latency_s``) against this service level."""
        rate = report.slo_violation_rate()
        return {
            "latency_slo_s": self.latency_s,
            "violations": report.slo_violations(),
            "violation_rate": rate,
            "max_violation_rate": self.max_violation_rate,
            "met": rate <= self.max_violation_rate,
        }


@dataclasses.dataclass(frozen=True)
class HttpService:
    """One HTTP-style service workload, frozen and hashable.

    ``request_mb`` is the mean payload; actual sizes are ``request_mb``
    times a menu multiplier (``size_menu``) chosen by quantizing an
    exponential draw in log space — heavy-ish tail, finitely many distinct
    dataset tuples.  ``conn_setup_mb`` is the cold-connection surcharge,
    ``keepalive_s`` the idle window a connection stays warm,
    ``think_s`` the mean exponential think time, and ``n_users`` the
    closed population size.  ``controllers`` are assigned per user
    (cycled by user index), so a service can A/B tuning policies across
    its user population in one run.
    """

    request_mb: float = 8.0
    size_menu: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    conn_setup_mb: float = 2.0
    keepalive_s: float = 30.0
    think_s: float = 5.0
    n_users: int = 16
    controllers: tuple = ("eemt",)
    profile: NetworkProfile = CHAMELEON
    total_s: float = 600.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "size_menu",
                           tuple(float(m) for m in self.size_menu))
        object.__setattr__(self, "controllers", tuple(self.controllers))
        if self.request_mb <= 0:
            raise ValueError(f"request_mb must be positive, got "
                             f"{self.request_mb}")
        if not self.size_menu or any(m <= 0 for m in self.size_menu):
            raise ValueError(f"size_menu needs positive multipliers, got "
                             f"{self.size_menu}")
        if self.conn_setup_mb < 0:
            raise ValueError(f"conn_setup_mb must be >= 0, got "
                             f"{self.conn_setup_mb}")
        if self.keepalive_s < 0:
            raise ValueError(f"keepalive_s must be >= 0, got "
                             f"{self.keepalive_s}")
        if self.think_s <= 0:
            raise ValueError(f"think_s must be positive, got {self.think_s}")
        if self.n_users < 1:
            raise ValueError(f"n_users must be >= 1, got {self.n_users}")
        if not self.controllers:
            raise ValueError("need at least one controller")


def _pick_size(service: HttpService, rng) -> float:
    """Quantize an exponential(1) draw onto the size menu in log space."""
    draw = max(float(rng.exponential(1.0)), 1e-9)
    menu = service.size_menu
    mult = min(menu, key=lambda m: abs(math.log(draw) - math.log(m)))
    return service.request_mb * mult


def http_request_stream(service: HttpService, *,
                        n_requests: Optional[int] = None,
                        name_prefix: str = "http",
                        ) -> Iterator[TransferRequest]:
    """Closed-loop request stream for ``service``, in arrival order.

    Yields :class:`TransferRequest` items ready for either fleet driver.
    A warm request carries one payload partition; a cold one an extra
    ``conn-setup`` partition first (so any ``max_partitions >= 2`` admits
    it).  ``n_requests`` bounds the stream for tests/benchmarks; ``None``
    streams forever (bound the run with ``OnlineConfig.horizon_s``).
    Deterministic: a pure function of ``(service, n_requests)``.
    """
    svc = service
    rngs = [np.random.default_rng([svc.seed, u])
            for u in range(svc.n_users)]
    warm_until = [-math.inf] * svc.n_users
    counts = [0] * svc.n_users
    # Stagger first arrivals with one think time each; heap order
    # (time, user) keeps ties deterministic.
    heap = [(float(rngs[u].exponential(svc.think_s)), u)
            for u in range(svc.n_users)]
    heapq.heapify(heap)
    issued = 0
    while n_requests is None or issued < n_requests:
        t, u = heapq.heappop(heap)
        rng = rngs[u]
        size = _pick_size(svc, rng)
        cold = t >= warm_until[u]
        payload = DatasetSpec(f"http-{size:g}mb", 1, size, size)
        if cold and svc.conn_setup_mb > 0:
            datasets = (DatasetSpec("conn-setup", 1, svc.conn_setup_mb,
                                    svc.conn_setup_mb), payload)
            total = svc.conn_setup_mb + size
        else:
            datasets = (payload,)
            total = size
        # Estimated service time: ideal time at the path's per-flow rate.
        est_s = total / max(svc.profile.bandwidth_mbps, 1e-9)
        warm_until[u] = t + est_s + svc.keepalive_s
        yield TransferRequest(
            arrival_s=t,
            datasets=datasets,
            controller=svc.controllers[u % len(svc.controllers)],
            profile=svc.profile,
            name=f"{name_prefix}-u{u:03d}-{counts[u]:06d}",
            total_s=svc.total_s,
        )
        counts[u] += 1
        issued += 1
        heapq.heappush(
            heap, (t + est_s + float(rng.exponential(svc.think_s)), u))


def http_request_trace(service: HttpService, *, n_requests: int,
                       name_prefix: str = "http",
                       ) -> tuple:
    """Materialized finite trace: ``n_requests`` items of
    :func:`http_request_stream` as a tuple, for the offline ``run_fleet``
    (already in arrival order, so it also feeds ``replay_stream`` for
    offline/online parity runs)."""
    if n_requests <= 0:
        raise ValueError(f"n_requests must be positive, got {n_requests}")
    return tuple(http_request_stream(service, n_requests=n_requests,
                                     name_prefix=name_prefix))
