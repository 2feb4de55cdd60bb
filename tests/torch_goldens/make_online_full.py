"""Regenerate ``online_full.json``: ``benchmarks/fleet.py --online
--smoke``'s leg (``build_online_stream(10_000)``: a diurnal stream of
10,000 transfers at 4-40 arrivals/s over a 1-hour period, seed 1810, 3
controllers x 3 HTTP-service dataset sizes; 4 hosts at 10x Chameleon's
NIC with no slot limit; ``wave_s=20.0, dt=1.0, pool_capacity=256``),
and the same settings at 1,000 transfers, as the JAX package's
``run_fleet_online`` computes them on the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_online_full.py

The 10,000-transfer leg runs with ``track_transfers=True``: its transfers
are stored as columns in the report's order (sorted by start time, then
name); ``name`` as the stream index, ``host`` and ``controller`` as
indices into the listed names.  Both legs keep their counters and totals.
The PyTorch port holds its own online fleet against this file
(chip_smoke.py phase 21b).
"""
import json
import os
import time

from benchmarks import fleet as bench
from repro import fleet
from repro.core.types import CHAMELEON

WAVE_S, DT, CAPACITY, N_HOSTS = 20.0, 1.0, 256, 4


def columns(transfers, hosts):
    names = [h.name for h in hosts]
    ctrls = sorted({t.controller for t in transfers})
    return {
        "controllers": ctrls,
        "hosts": names,
        "index": [int(t.name.rsplit("-", 1)[1]) for t in transfers],
        "controller": [ctrls.index(t.controller) for t in transfers],
        "host": [names.index(t.host) for t in transfers],
        "arrival_s": [t.arrival_s for t in transfers],
        "start_s": [t.start_s for t in transfers],
        "time_s": [t.time_s for t in transfers],
        "energy_j": [t.energy_j for t in transfers],
        "moved_mb": [t.moved_mb for t in transfers],
        "completed": [int(t.completed) for t in transfers],
    }


def run(n, track):
    hosts = fleet.host_pool(N_HOSTS, nic_mbps=10.0 * CHAMELEON.bandwidth_mbps,
                            slots=0)
    t0 = time.perf_counter()
    rep = fleet.run_fleet_online(bench.build_online_stream(n), hosts,
                                 wave_s=WAVE_S, dt=DT,
                                 pool_capacity=CAPACITY,
                                 track_transfers=track)
    wall = time.perf_counter() - t0
    out = {"transfers": rep.fold.transfers, "n_hosts": len(hosts),
           "sim_s": rep.sim_s, "waves": rep.waves, "dropped": rep.dropped,
           "n_completed": rep.completed,
           "total_energy_j": rep.total_energy_j, "total_gb": rep.total_gb,
           "counters": rep.counters,
           "host_stats": [[h.name, h.moved_mb, h.busy_frac, h.nic_util,
                           h.peak_active] for h in rep.host_stats]}
    if track:
        out.update(columns(rep.transfers, hosts))
    return out, wall


def main():
    out = {"source": "benchmarks.fleet.build_online_stream(n) through "
                     "repro.fleet.run_fleet_online(wave_s=20.0, dt=1.0, "
                     "pool_capacity=256) on 4 hosts, JAX package on the "
                     "CPU",
           "wave_s": WAVE_S, "dt": DT, "pool_capacity": CAPACITY}
    for key, n, track in (("small", 1_000, False), ("full", 10_000, True)):
        out[key], wall = run(n, track)
        print(f"{key}: {out[key]['transfers']} transfers, "
              f"{out[key]['waves']} waves, sim_s {out[key]['sim_s']} in "
              f"{wall:.1f} s on the CPU")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "online_full.json")
    with open(path, "w") as f:
        json.dump(out, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
