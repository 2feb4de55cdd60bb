"""Regenerate ``fleet_full.json``: ``benchmarks/fleet.py``'s offline fleet
(``build()``: 10,000 Poisson transfers at 0.8/s, seed 1810, 6 controllers
x 4 dataset mixes, 8 hosts x 16 slots; ``--smoke``: 400 transfers / 4
hosts), run with ``wave_s=15.0, dt=0.5`` as the benchmark runs it, as the
JAX package computes it on the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_fleet_full.py

Per-transfer fields are stored as columns in the report's order (sorted by
start time, then name); ``name`` as the trace index, ``host`` and
``controller`` as indices into the listed names.  The PyTorch port holds
its own fleet against this file (chip_smoke.py phase 20b).
"""
import json
import os
import time

from benchmarks import fleet as bench
from repro import fleet

WAVE_S, DT = 15.0, 0.5


def columns(report, hosts):
    names = [h.name for h in hosts]
    ctrls = sorted({t.controller for t in report.transfers})
    ts = report.transfers
    return {
        "controllers": ctrls,
        "hosts": names,
        "index": [int(t.name.rsplit("-", 1)[1]) for t in ts],
        "controller": [ctrls.index(t.controller) for t in ts],
        "host": [names.index(t.host) for t in ts],
        "start_s": [t.start_s for t in ts],
        "time_s": [t.time_s for t in ts],
        "energy_j": [t.energy_j for t in ts],
        "moved_mb": [t.moved_mb for t in ts],
        "completed": [int(t.completed) for t in ts],
    }


def run(smoke):
    trace, hosts = bench.build(smoke=smoke)
    t0 = time.perf_counter()
    report = fleet.run_fleet(trace, hosts, wave_s=WAVE_S, dt=DT)
    wall = time.perf_counter() - t0
    s = report.summary()
    return {
        "transfers": len(trace), "n_hosts": len(hosts),
        "sim_s": report.sim_s, "waves": report.waves,
        "dropped": report.dropped, "completed": report.completed,
        "total_energy_j": report.total_energy_j,
        "joules_per_gb": report.joules_per_gb,
        "by_controller": {k: {"joules_per_gb": v["joules_per_gb"],
                              "p99_slowdown": v["slowdown"]["p99"]}
                          for k, v in s["by_controller"].items()},
        **columns(report, hosts),
    }, wall


def main():
    out = {"source": "benchmarks.fleet.build(smoke) through "
                     "repro.fleet.run_fleet(wave_s=15.0, dt=0.5), JAX "
                     "package on the CPU",
           "wave_s": WAVE_S, "dt": DT}
    for key, smoke in (("smoke", True), ("full", False)):
        out[key], wall = run(smoke)
        print(f"{key}: {out[key]['transfers']} transfers, "
              f"{out[key]['waves']} waves in {wall:.1f} s on the CPU")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fleet_full.json")
    with open(path, "w") as f:
        json.dump(out, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
