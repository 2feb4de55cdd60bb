"""Learned-vs-heuristic evaluation grid (the port of
``repro/learn/evaluate.py``).

Scores a :class:`~repro_torch.learn.controller.LearnedController` against
the paper tuners (ME / EEMT / EETT) and a static baseline on the
fig2-style testbed × dataset grid, as one declarative
``repro_torch.api.Experiment`` — scenarios sharing a code path batch into
one lane batch (one tick-kernel launch on a card, the learned policy's
weights an input table of the kernel), cells cache under content-hashed
keys (retrained params invalidate), and the result is the same columnar
``api.Report`` the figure benchmarks emit.
"""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch import api
from repro_torch.core.types import (CHAMELEON, CLOUDLAB, CpuProfile, MIXED,
                                    SMALL_FILES)

TESTBEDS = {"chameleon": CHAMELEON, "cloudlab": CLOUDLAB}
DATASETS = {"small": (SMALL_FILES,), "mixed": MIXED}

SMOKE_TESTBEDS = ("chameleon",)
SMOKE_DATASETS = ("small", "mixed")


def default_rivals(*, max_ch: int = 64,
                   target_tput_mbps: float = 500.0) -> dict:
    """The heuristic line-up the learned policy is scored against."""
    return {
        "ME": api.make_controller("ME", max_ch=max_ch),
        "EEMT": api.make_controller("EEMT", max_ch=max_ch),
        "EETT": api.make_controller("eett", max_ch=max_ch,
                                    target_tput_mbps=target_tput_mbps),
        "wget/curl": "wget/curl",
    }


def evaluation_experiment(learned, *, rivals: Optional[Mapping] = None,
                          smoke: bool = True, total_s: float = 900.0,
                          cpu: CpuProfile = CpuProfile()) -> api.Experiment:
    """The learned-vs-heuristic grid as a declarative Experiment.

    ``learned`` is any Controller (typically a LearnedController); it runs
    under the tool label ``"learned"`` next to ``rivals``
    (:func:`default_rivals` when omitted).
    """
    testbeds = SMOKE_TESTBEDS if smoke else tuple(TESTBEDS)
    datasets = SMOKE_DATASETS if smoke else tuple(DATASETS)
    tools = {"learned": learned}
    tools.update(rivals if rivals is not None else default_rivals())
    return api.Experiment(
        name="learn_eval",
        space=api.grid(
            api.axis("testbed", {tb: TESTBEDS[tb] for tb in testbeds},
                     field="profile"),
            api.axis("dataset", {ds: DATASETS[ds] for ds in datasets},
                     field="datasets"),
            api.axis("tool", tools, field="controller")),
        base={"cpu": cpu, "total_s": total_s})


def evaluate(learned, *, rivals: Optional[Mapping] = None,
             smoke: bool = True, total_s: float = 900.0,
             cache: Optional[str] = None,
             timing: str = "split", device=None) -> api.Report:
    """Run the grid on ``device`` (default ``"cuda"``) and return the
    scored Report."""
    exp = evaluation_experiment(learned, rivals=rivals, smoke=smoke,
                                total_s=total_s)
    return exp.run(cache=cache, timing=timing, device=device)


def vs_teacher(report: api.Report, teacher: str) -> dict:
    """Per-(testbed, dataset) energy/throughput ratios of the learned
    policy against one heuristic tool; ratios < 1 mean the learned
    controller used less energy (resp. was slower)."""
    out = {}
    for tb in dict.fromkeys(report["testbed"]):
        for ds in dict.fromkeys(report.select(testbed=tb)["dataset"]):
            cell = report.select(testbed=tb, dataset=ds)
            rows = {r["tool"]: r for r in cell.rows()}
            if "learned" not in rows or teacher not in rows:
                continue
            le, te = rows["learned"], rows[teacher]
            out[f"{tb}/{ds}"] = {
                "energy_ratio": le["energy_j"] / max(te["energy_j"], 1e-9),
                "tput_ratio": le["avg_tput_MBps"]
                / max(te["avg_tput_MBps"], 1e-9),
                "learned_completed": bool(le["completed"]),
                "teacher_completed": bool(te["completed"]),
            }
    return out
