"""Regenerate ``learn_full.json``: ``benchmarks/learn.py``'s learning path
as the JAX package computes it on the CPU — the BC policy of its
``train()`` (EEMT, max_ch 64, teacher on Chameleon x small and mixed at
900 s; 400 steps, batch 256, lr 3e-3, seed 0) and the full evaluation grid
(``evaluate(learned, smoke=False)``: {chameleon, cloudlab} x {small,
mixed} x {learned, ME, EEMT, EETT, wget/curl} at 900 s), with, for every
learned cell, the smallest top-two logit margin over its controller ticks
relative to that tick's largest |logit| (its smallest over the heads).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_goldens/make_learn_full.py

The PyTorch port runs the grid with these params through its tick kernel
and holds it to this file (chip_smoke.py, phase 18).
"""
import json
import os

import numpy as np

FIELDS = ("completed", "time_s", "energy_j", "avg_tput_MBps",
          "avg_tput_gbps", "avg_power_w")


def _margin(learned, scenario):
    """(smallest relative top-two margin, controller ticks, largest
    |logit|) of JAX's policy over a learned run's controller ticks."""
    import jax.numpy as jnp

    from repro import learn

    run, = learn.run_observed([scenario])
    obs = run.obs
    mask = np.asarray(obs.is_ctrl, bool)
    if not mask.any():
        return None, 0, 0.0
    feats = learn.featurize(obs.avg_tput, obs.avg_power, obs.cpu_load,
                            obs.remaining_mb, obs.num_ch, obs.cores,
                            obs.freq_idx, net=run.prep.inputs.net,
                            sla=run.prep.inputs.sla, cpu=scenario.cpu)
    logits = np.asarray(learn.apply_policy(learned.cfg, learned.params,
                                           jnp.asarray(feats)))[mask]
    top = np.sort(logits, axis=-1)
    gap = (top[..., -1] - top[..., -2]).min(axis=-1)
    scale = np.abs(logits).max(axis=(-1, -2))
    return (float((gap / np.maximum(scale, 1e-30)).min()), int(mask.sum()),
            float(scale.max()))


def main():
    from benchmarks import learn as learn_bench
    from repro import api, learn

    learned, record = learn_bench.train(smoke=True)
    exp = learn.evaluation_experiment(learned, smoke=False)
    cells = exp.cells()
    report = exp.run()
    rows = []
    margins = {}
    for cell, r in zip(cells, report.rows()):
        rows.append({**{a: r[a] for a in ("testbed", "dataset", "tool")},
                     **{f: (bool(r[f]) if f == "completed" else float(r[f]))
                        for f in FIELDS}})
        if r["tool"] == "learned":
            m, ticks, scale = _margin(learned, cell.scenario)
            margins[f"{r['testbed']}/{r['dataset']}"] = {
                "margin": m, "ctrl_ticks": ticks, "max_abs_logit": scale}
    out = {
        "source": "benchmarks.learn.train() and repro.learn.evaluate("
                  "learned, smoke=False), JAX package on the CPU",
        "train": {k: record[k] for k in ("teacher", "samples", "loss_first",
                                         "loss_last")},
        "params": {k: np.asarray(v, np.float32).tolist()
                   for k, v in sorted(learned.params.items())},
        "digest": learned.digest,
        "group_count": api.group_count([c.scenario for c in cells]),
        "rows": rows,
        "margins": margins,
        "vs_teacher": learn.vs_teacher(report, "EEMT"),
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "learn_full.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {len(rows)} rows, margins {margins}")


if __name__ == "__main__":
    main()
