"""Workloads of the PyTorch port.

* :mod:`repro_torch.workloads.logfit` — fit simulator network parameters
  from historical per-transfer logs (CSV/JSON) into a piecewise bandwidth
  schedule (:class:`LogFitNetworkModel`), registered as
  ``make_environment("logfit", log=...)``.

The JAX package's HTTP-service streams and fault injection (its
``workloads.http`` / ``workloads.faults``) ride on its fleet layer, which
the port does not have yet.
"""
from .logfit import (LogFitNetworkModel, LogRecord,  # noqa: F401
                     fit_network_log, load_transfer_log,
                     logfit_environment)

__all__ = [
    "LogFitNetworkModel", "LogRecord", "fit_network_log",
    "load_transfer_log", "logfit_environment",
]
