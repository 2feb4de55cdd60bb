"""Regenerate ``tune_full.json``: ``examples/tune_controller.py``'s search
(EEMT's ``max_ch`` x ``max_load`` grid on Chameleon, a 300 GB workload in
a 120 s budget, minimise energy subject to >= 2 Gbps, CRN seeds 0-2,
``refine=2``) as the JAX package computes it on the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_tune_full.py

The PyTorch port holds its own ``tune`` of the same search against this
file (chip_smoke.py phase 20c).
"""
import contextlib
import io
import json
import os
import runpy
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = runpy.run_path(os.path.join(HERE, "..", "..", "examples",
                                          "tune_controller.py"))["result"]
    wall = time.perf_counter() - t0
    out = {"source": "examples/tune_controller.py's api.tune, JAX package "
                     "on the CPU",
           "best": res.best, "best_labels": res.best_labels,
           "best_value": res.best_value, "best_metrics": res.best_metrics,
           "feasible": res.feasible, "n_evals": res.n_evals,
           "report": res.report.to_dict()}
    path = os.path.join(HERE, "tune_full.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"tune: {res.n_evals} evaluations in {wall:.1f} s on the CPU; "
          f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
