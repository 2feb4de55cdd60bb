"""repro_torch.fleet — trace-driven, fleet-scale transfer simulation.

The PyTorch port of ``repro.fleet``'s offline half.  It runs thousands of
concurrent transfers — Poisson or replayed-trace arrivals across a pool of
hosts, each host with a transfer-slot budget and a shared NIC whose
capacity is split among its in-flight transfers — on top of the
``repro_torch.api`` Scenario/engine substrate.

Execution is in streaming *waves*: all active transfers advance by one wave
window (on a card, one launch of the tick kernel's wave mode for every
(controller code, environment code, cpu) group of the wave), completed
lanes are drained and refilled from the arrival queue, and per-host NIC
contention rescales each transfer's available bandwidth between waves.
Pools may be heterogeneous: every :class:`Host` carries its own CPU
profile and its own ``repro_torch.api`` Environment.

Quickstart::

    from repro_torch import fleet
    from repro_torch.core.types import CHAMELEON, DatasetSpec

    hosts = fleet.host_pool(8, nic_mbps=1250.0, slots=16)
    trace = fleet.poisson_trace(
        rate_per_s=2.0, n_transfers=1000, seed=0,
        datasets=((DatasetSpec("d", 100, 2000.0, 20.0),),),
        controllers=("eemt", "me", "wget/curl"),
        profile=CHAMELEON)
    report = fleet.run_fleet(trace, hosts, wave_s=30.0, dt=0.1)  # the card
    print(report.summary())

The online loop (``run_fleet_online``, ``OnlineConfig``, ``SlotPool``) is
the next slice of the port; its stream adapters (``poisson_stream``,
``diurnal_stream``, ``replay_stream``) and streaming aggregates
(``FleetFold``, ``OnlineFleetReport``) are here already.
"""
from .aggregates import (FleetFold, FleetReport,  # noqa: F401
                         FleetTransfer, OnlineFleetReport, QuantileSketch)
from .arrivals import (TransferRequest, diurnal_stream,  # noqa: F401
                       poisson_stream, poisson_trace, replay_stream,
                       replay_trace)
from .hosts import Host, host_pool  # noqa: F401
from .scheduler import run_fleet  # noqa: F401

__all__ = [
    "FleetFold", "FleetReport", "FleetTransfer", "Host",
    "OnlineFleetReport", "QuantileSketch", "TransferRequest",
    "diurnal_stream", "host_pool", "poisson_stream", "poisson_trace",
    "replay_stream", "replay_trace", "run_fleet",
]
