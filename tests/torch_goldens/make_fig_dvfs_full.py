"""Regenerate ``fig_dvfs_full.json``: the DVFS grids as the JAX package
computes them on the CPU — the 18 cells of ``benchmarks/fig_dvfs.py``
(3 tools x 3 frequency caps x 2 core counts, Chameleon x MIXED at
``budget_for``) and its 24 GreenDataFlow cells (2 testbeds x hp/lp x
race/pace x 3 tools).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_fig_dvfs_full.py

The PyTorch port holds its own runs of both grids against this file
(chip_smoke.py, phase 17).
"""
import json
import os

from benchmarks import fig_dvfs

FIELDS = ("completed", "time_s", "energy_j", "avg_tput_MBps",
          "avg_tput_gbps", "avg_power_w")


def _grid(exp, axes):
    from repro import api

    report = exp.run()
    rows = [{**{a: r[a] for a in axes},
             **{f: (bool(r[f]) if f == "completed" else float(r[f]))
                for f in FIELDS}}
            for r in report.rows()]
    return report, {
        "group_count": api.group_count([c.scenario for c in exp.cells()]),
        "rows": rows}


def main():
    report, dvfs = _grid(fig_dvfs.experiment(smoke=False),
                         ("tool", "fcap", "cores"))
    dvfs["headline"] = fig_dvfs.headline(report)
    _, gdf = _grid(fig_dvfs.greendataflow(),
                   ("testbed", "tech", "idle", "tool"))
    out = {"source": "benchmarks.fig_dvfs.experiment(smoke=False).run() and "
                     "benchmarks.fig_dvfs.greendataflow().run(), JAX package "
                     "on the CPU",
           "fig_dvfs": dvfs, "greendataflow": gdf}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fig_dvfs_full.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {len(dvfs['rows'])} + {len(gdf['rows'])} rows")


if __name__ == "__main__":
    main()
