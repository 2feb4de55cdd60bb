"""Regenerate ``workloads_full.json``: ``benchmarks/workloads.py
--smoke``'s HTTP grid and fault leg, as the JAX package computes them on
the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_workloads_full.py

* HTTP grid (``http_cells(smoke=True)``): 2 controllers x connection reuse
  (keepalive 30 s / 0) x latency SLO (6 s / 30 s), each cell an 80-request
  ``HttpService(**HTTP_SERVICE)`` trace (8 users, 64 MB menu, seed 1810)
  on 2 hosts at 4x Chameleon's NIC, through ``run_fleet(wave_s=5.0,
  dt=0.25, slo_s=...)`` and ``run_fleet_online(..., pool_capacity=256)``.
* Fault leg (``run_faults(smoke=True)``): 12 bulk transfers on 2 hosts x
  4 slots under a seed-7 generated schedule plus named kills, restart
  ``resume`` and ``scratch``, both drivers (``wave_s=10.0, dt=0.5``,
  online ``pool_capacity=64``).

Per HTTP cell: completed, SLO violations (both drivers), total energy and
GB.  Per fault mode: the churn ledger, completed, total energy and GB.
The PyTorch port holds its own runs against this file (chip_smoke.py
phase 21c).
"""
import json
import math
import os
import time

from benchmarks import workloads as bench
from repro import fleet
from repro.core.types import CHAMELEON
from repro.workloads import (FaultSchedule, HttpService, KillTransfer,
                             http_request_trace)


def http_grid():
    hosts = fleet.host_pool(2, nic_mbps=4.0 * CHAMELEON.bandwidth_mbps,
                            slots=0)
    cells = []
    for cell in bench.http_cells(smoke=True):
        svc = HttpService(controllers=(cell["controller"],),
                          keepalive_s=cell["keepalive_s"],
                          **bench.HTTP_SERVICE)
        trace = http_request_trace(svc, n_requests=cell["n_requests"])
        off = fleet.run_fleet(trace, hosts, wave_s=5.0, dt=0.25,
                              slo_s=cell["slo_s"])
        on = fleet.run_fleet_online(trace, hosts, wave_s=5.0, dt=0.25,
                                    slo_s=cell["slo_s"], pool_capacity=256)
        cells.append({
            **{k: cell[k] for k in ("controller", "reuse", "slo",
                                    "keepalive_s", "slo_s", "n_requests")},
            "completed": off.completed, "online_completed": on.completed,
            "violations": off.slo_violations(),
            "online_violations": on.slo_violations(),
            "energy_j": off.total_energy_j, "gb": off.total_gb,
            "online_energy_j": on.total_energy_j, "online_gb": on.total_gb,
            "sim_s": off.sim_s, "waves": off.waves,
            "online_sim_s": on.sim_s, "online_waves": on.waves})
    return cells


def fault_leg():
    """benchmarks/workloads.py::run_faults(smoke=True)'s trace, pool and
    schedules."""
    n = 12
    trace = fleet.poisson_trace(
        rate_per_s=0.05, n_transfers=n, seed=1810,
        datasets=bench.FAULT_DATASETS, controllers=("eemt", "me"),
        profile=CHAMELEON, total_s=3600.0)
    hosts = fleet.host_pool(2, nic_mbps=2.0 * CHAMELEON.bandwidth_mbps,
                            slots=4)
    horizon = max(r.arrival_s for r in trace) + 600.0
    base = FaultSchedule.generate(
        n_hosts=2, horizon_s=horizon, seed=7,
        host_loss_per_hour=18.0, outage_s=60.0,
        nic_degrade_per_hour=12.0, degrade_s=120.0)
    kills = tuple(
        KillTransfer(trace[i].name,
                     math.ceil(trace[i].arrival_s / 10.0) * 10.0 + 5.0)
        for i in range(0, n, 5))
    out = {"horizon_s": horizon, "n_events": len(base.events) + len(kills)}
    for mode in ("resume", "scratch"):
        fs = FaultSchedule(events=base.events + kills, restart=mode)
        off = fleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5, faults=fs)
        on = fleet.run_fleet_online(
            sorted(trace, key=lambda r: r.arrival_s), hosts, wave_s=10.0,
            dt=0.5, faults=fs, pool_capacity=64, track_transfers=True)
        assert on.churn == off.churn
        out[mode] = {"churn": off.churn, "completed": off.completed,
                     "energy_j": off.total_energy_j, "gb": off.total_gb,
                     "sim_s": off.sim_s, "waves": off.waves,
                     "online_sim_s": on.sim_s, "online_waves": on.waves}
    return out


def main():
    t0 = time.perf_counter()
    out = {"source": "benchmarks/workloads.py --smoke's HTTP grid and fault "
                     "leg through repro.fleet.run_fleet and "
                     "run_fleet_online, JAX package on the CPU",
           "http": http_grid(), "faults": fault_leg()}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "workloads_full.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
