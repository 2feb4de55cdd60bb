"""Regenerate ``fig2_full.json``: the 72 cells of the paper's Figure 2 grid
(3 testbeds x 4 datasets x 6 tools at ``budget_for`` horizons) as the JAX
package computes them on the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_fig2_full.py

The PyTorch port holds its own Figure 2 run against this file
(tests/test_torch_api.py and chip_smoke.py).
"""
import json
import os

from benchmarks import fig2

FIELDS = ("completed", "time_s", "energy_j", "avg_tput_MBps",
          "avg_tput_gbps", "avg_power_w")


def main():
    exp = fig2.experiment(smoke=False)
    report = exp.run()
    rows = [{"testbed": r["testbed"], "dataset": r["dataset"],
             "tool": r["tool"],
             **{f: (bool(r[f]) if f == "completed" else float(r[f]))
                for f in FIELDS}}
            for r in report.rows()]
    from repro import api
    out = {"source": "benchmarks.fig2.experiment(smoke=False).run(), "
                     "JAX package on the CPU",
           "group_count": api.group_count([c.scenario for c in exp.cells()]),
           "headline": fig2.headline(report),
           "rows": rows}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fig2_full.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {len(rows)} rows")


if __name__ == "__main__":
    main()
