"""Operator-grade workloads for the fleet layer: services, faults, logs
(the port of ``repro.workloads``).

``repro_torch.fleet`` runs traces and streams of transfers; this package
supplies the workloads an operator actually faces, each expressed in the
fleet layer's existing vocabulary so both drivers (offline ``run_fleet``,
online ``run_fleet_online``) consume them unchanged:

* :mod:`repro_torch.workloads.http` — HTTP-service request streams:
  closed-loop users issuing many small transfers, persistent-connection
  reuse (cold connections pay a startup-bytes surcharge), and per-request
  latency SLOs (:class:`ServiceLevel`) judged against the fleet report's
  latency quantiles and violation counter.
* :mod:`repro_torch.workloads.faults` — deterministic, seed-keyed fault
  and churn injection (:class:`FaultSchedule`): host loss, NIC-degradation
  windows, and transfer kill/restart, with killed transfers resuming from
  their remaining bytes and a goodput-vs-throughput :class:`ChurnFold`
  ledger whose byte conservation is bit-exact.
* :mod:`repro_torch.workloads.logfit` — fit simulator network parameters
  from historical per-transfer logs (CSV/JSON) into a piecewise bandwidth
  schedule (:class:`LogFitNetworkModel`), registered as
  ``make_environment("logfit", log=...)``.

Import direction: this package imports ``repro_torch.fleet`` and
``repro_torch.api``; neither imports it back (the fleet drivers take fault
schedules duck-typed, and the ``logfit`` registry entry is a lazy
factory).  Request streams and fault schedules are host numpy, as in the
JAX package.
"""
from .faults import (ChurnFold, FaultSchedule, HostDown,  # noqa: F401
                     KillTransfer, NicDegrade)
from .http import (HttpService, ServiceLevel,  # noqa: F401
                   http_request_stream, http_request_trace)
from .logfit import (LogFitNetworkModel, LogRecord,  # noqa: F401
                     fit_network_log, load_transfer_log,
                     logfit_environment)

__all__ = [
    "ChurnFold", "FaultSchedule", "HostDown", "KillTransfer", "NicDegrade",
    "HttpService", "ServiceLevel", "http_request_stream",
    "http_request_trace",
    "LogFitNetworkModel", "LogRecord", "fit_network_log",
    "load_transfer_log", "logfit_environment",
]
