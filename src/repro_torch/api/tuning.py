"""Offline auto-tuning over Experiment grids.

GreenDataFlow and the historical-log cross-layer line of work frame
energy-efficient transfer tuning as *offline search over past runs followed
by online refinement*.  The batched sweep substrate makes the offline half
cheap: on a card a whole rung of candidate configurations evaluates as one
launch of the tick kernel per partition count among its cells.
:func:`tune` searches an :class:`~repro_torch.api.experiments.Experiment`
grid for the configuration optimizing an objective metric subject to an
optional constraint, via:

* **successive halving** — rungs evaluate every surviving candidate on a
  growing number of replications and keep the top ``1/eta`` by the running
  mean of the objective; each rung is ONE sweep batch.
* **common random numbers (CRN)** — replications are seeded bandwidth
  schedules shared by *every* candidate in a rung, so comparisons are
  paired: candidate A and B always face the identical sequence of network
  conditions, which removes the variance a per-candidate draw would add
  and makes repeated ``tune`` calls bit-deterministic.
* **grid refine** — optional continuation: after the coarse-grid winner is
  found, numeric axes are bisected around the winner for ``refine`` extra
  rounds (midpoints between the winner and its bracketing grid neighbors),
  reusing the same CRN seeds.

With no ``seeds`` the simulation is fully deterministic, every rung is
exact, and successive halving provably returns the grid argmin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from .experiments import (Cell, Experiment, _cache_read, _cache_write,
                          _iter_axes, scenario_key)
from .report import RESULT_METRICS, Report, derive_row
from .scenario import sweep

Constraint = Union[Tuple[str, str, float], Callable[[dict], bool], None]

_OPS = {">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, "<": lambda a, b: a < b}


def crn_bw_schedule(seed: int, n_steps: int, *, lo: float = 0.55,
                    hi: float = 1.0) -> np.ndarray:
    """Deterministic per-seed bandwidth schedule (fraction of link rate).

    A smooth mixture of random-phase sinusoids, clipped to ``[lo, hi]`` —
    depends only on ``(seed, n_steps, lo, hi)``, never on the candidate
    being evaluated, which is what makes it a *common* random number.
    """
    rng = np.random.default_rng(int(seed))
    t = np.arange(n_steps, dtype=np.float64)
    sched = np.full(n_steps, (lo + hi) / 2.0)
    for _ in range(4):
        period = rng.uniform(30.0, 600.0)
        phase = rng.uniform(0.0, 2.0 * np.pi)
        amp = rng.uniform(0.05, 0.25) * (hi - lo)
        sched = sched + amp * np.sin(2.0 * np.pi * t / period + phase)
    return np.clip(sched, lo, hi).astype(np.float32)


def _with_seed(cell: Cell, seed: Optional[int]):
    sc = cell.scenario
    if seed is None:
        return sc
    n_steps = int(round(sc.total_s / sc.dt))
    return dataclasses.replace(sc, bw_schedule=crn_bw_schedule(seed, n_steps))


def _normalize_constraint(constraint: Constraint) -> Optional[Callable]:
    if constraint is None:
        return None
    if callable(constraint):
        return constraint
    metric, op, value = constraint
    if op not in _OPS:
        raise ValueError(f"constraint op must be one of {sorted(_OPS)}, "
                         f"got {op!r}")
    return lambda row, _m=metric, _o=_OPS[op], _v=value: _o(row[_m], _v)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`tune` search."""

    best: dict                  # axis name -> winning raw value
    best_labels: dict           # axis name -> winning label
    best_metrics: dict          # CRN-mean metrics of the winner
    best_value: float           # winner's mean objective
    objective: str
    mode: str                   # "min" | "max"
    feasible: bool              # winner satisfies the constraint
    report: Report              # every evaluation the search performed
    n_evals: int


class _Search:
    """Bookkeeping shared by the halving and refine phases."""

    def __init__(self, experiment: Experiment, seeds, sweeper, cache):
        self.exp = experiment
        self.seeds = list(seeds) if seeds else [None]
        self.sweeper = sweeper
        self.cache = cache
        self.axes = experiment.axis_names
        self.rows_labels: list[dict] = []
        self.rows_metrics: list[dict] = []
        self.n_evals = 0
        # per candidate-key: metric -> per-seed values (insertion order =
        # seed order, identical across candidates: that is the pairing)
        self.evals: dict[str, dict[str, list[float]]] = {}

    def evaluate(self, cells: Sequence[Cell], seed_slice: Sequence,
                 round_id: int) -> None:
        """One rung: every new (cell, seed) pair in one sweep batch.

        Pairs already evaluated are skipped (a refine round can re-propose
        the incumbent); with a ``cache`` directory, pairs whose seeded
        scenario hashes to a stored record are served from disk.
        """
        todo = []
        for s in seed_slice:
            for c in cells:
                done = self.evals.get(c.key, {})
                n_seen = len(next(iter(done.values()))) if done else 0
                if self.seeds.index(s) < n_seen:
                    continue
                todo.append((c, s))
        if not todo:
            return
        records: list = [None] * len(todo)
        miss = []
        for i, (c, s) in enumerate(todo):
            if self.cache is not None:
                key = scenario_key(_with_seed(c, s))
                rec = _cache_read(self.cache, key)
                if rec is not None:
                    records[i] = rec
                    continue
            miss.append(i)
        if miss:
            results = self.sweeper([_with_seed(*todo[i]) for i in miss])
            for i, res in zip(miss, results):
                rec = {m: float(getattr(res, m)) for m in RESULT_METRICS}
                records[i] = rec
                if self.cache is not None:
                    c, s = todo[i]
                    _cache_write(self.cache,
                                 scenario_key(_with_seed(c, s)), rec)
        for (c, s), rec in zip(todo, records):
            metrics = derive_row({m: rec[m] for m in RESULT_METRICS})
            store = self.evals.setdefault(c.key, {m: [] for m in metrics})
            for m, v in metrics.items():
                store[m].append(v)
            self.rows_labels.append(dict(
                c.labels, seed="-" if s is None else str(s),
                round=str(round_id)))
            self.rows_metrics.append(metrics)
            self.n_evals += 1

    def mean_metrics(self, cell: Cell) -> dict:
        store = self.evals[cell.key]
        return {m: float(np.mean(vs)) for m, vs in store.items()}

    def report(self, meta: dict) -> Report:
        axes = tuple(self.axes) + ("seed", "round")
        cols: dict[str, list] = {a: [] for a in axes}
        metric_names = (tuple(self.rows_metrics[0]) if self.rows_metrics
                        else tuple(RESULT_METRICS))
        cols.update({m: [] for m in metric_names})
        for lab, met in zip(self.rows_labels, self.rows_metrics):
            for a in axes:
                cols[a].append(lab[a])
            for m in metric_names:
                cols[m].append(met[m])
        return Report(cols, axes=axes, meta=meta)


def _rank(search: _Search, cells: Sequence[Cell], objective: str, mode: str,
          check) -> list[int]:
    """Candidate indices sorted best-first (infeasible rank last, stably)."""
    scores = []
    for i, c in enumerate(cells):
        mm = search.mean_metrics(c)
        s = mm[objective]
        if mode == "max":
            s = -s
        if check is not None and not check(mm):
            s = math.inf
        scores.append(s)
    return list(np.argsort(np.asarray(scores), kind="stable"))


def _numeric_axes(experiment: Experiment) -> dict:
    """Axes whose grid values are all real numbers -> sorted unique values."""
    out = {}
    for ax in _iter_axes(experiment.space):
        vals = ax.values
        if len(vals) >= 2 and all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in vals):
            out[ax.name] = (sorted(set(float(v) for v in vals)),
                            all(isinstance(v, int) for v in vals))
    return out


def _bracket(sorted_vals: Sequence[float], x: float) -> tuple:
    lo = max((v for v in sorted_vals if v < x), default=None)
    hi = min((v for v in sorted_vals if v > x), default=None)
    return lo, hi


def tune(experiment: Experiment, objective: str,
         constraint: Constraint = None, *, mode: str = "min",
         seeds: Optional[Sequence[int]] = None, eta: int = 3,
         refine: int = 0, sweeper: Optional[Callable] = None,
         cache: Optional[str] = None, device=None) -> TuneResult:
    """Search ``experiment``'s grid for the best configuration.

    objective   metric column to optimize (``energy_j``, ``joules_per_gb``,
                ``avg_tput_gbps``, ...).
    constraint  ``(metric, op, value)`` with op in >=/<=/>/<, or a callable
                on the candidate's CRN-mean metric dict; infeasible
                candidates rank last and the result's ``feasible`` flag
                reports whether the winner passes.
    mode        "min" (default) or "max".
    seeds       CRN replication seeds.  ``None`` -> one deterministic
                evaluation per candidate (the simulator itself is
                deterministic), in which case successive halving is exact
                and returns the grid argmin.
    eta         halving rate: each rung keeps ``ceil(n / eta)`` candidates.
    refine      extra grid-refine rounds bisecting numeric axes around the
                winner (0 disables).
    sweeper     replaces :func:`repro_torch.api.sweep` (tests spy through
                this); it is called with the list of scenarios alone.
    cache       directory of per-(cell, seed) result records, in
                :meth:`Experiment.run`'s cache format.
    device      where :func:`repro_torch.api.sweep` runs the rungs
                (``None``: the CUDA device, as everywhere in the port).

    Derived metrics (``joules_per_gb``, ``gb``, ``edp``) are available as
    objective/constraint metrics in addition to :data:`RESULT_METRICS`.
    """
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    check = _normalize_constraint(constraint)
    if sweeper is None:
        def sweeper(scenarios):
            return sweep(scenarios, device=device)
    search = _Search(experiment, seeds, sweeper, cache)
    cells = experiment.cells()
    if not cells:
        raise ValueError("experiment has no cells")

    # -------------------------------------------------- successive halving
    seed_list = search.seeds
    si = 0                      # seeds consumed so far
    round_id = 0
    cand = list(cells)
    while True:
        n_new = min(max(eta ** round_id, 1), len(seed_list) - si) \
            if si < len(seed_list) else 0
        if n_new:
            search.evaluate(cand, seed_list[si:si + n_new], round_id)
            si += n_new
        if len(cand) == 1 and si >= len(seed_list):
            break
        if len(cand) > 1:
            keep = max(1, math.ceil(len(cand) / eta))
            order = _rank(search, cand, objective, mode, check)
            cand = [cand[i] for i in sorted(order[:keep])]
        elif si >= len(seed_list):
            break
        round_id += 1
    best = cand[0]

    # -------------------------------------------------------- grid refine
    numeric = _numeric_axes(experiment) if refine else {}
    # Brackets only for numeric axes the winner actually has a value on: a
    # chain() sub-space winner may lack an axis entirely (value None).
    brackets = {}
    for name, (vals, _) in numeric.items():
        v = best.values.get(name)
        if v is not None:
            brackets[name] = _bracket(vals, float(v))
    for step in range(refine):
        if not brackets:
            break
        round_id += 1
        proposals = [dict(best.values)]
        for name, (_, is_int) in numeric.items():
            if name not in brackets:
                continue
            x = float(best.values[name])
            lo, hi = brackets[name]
            for side, bound in (("lo", lo), ("hi", hi)):
                if bound is None:
                    continue
                mid = (x + bound) / 2.0
                if is_int:
                    mid = float(int(round(mid)))
                if mid == x or mid == bound:
                    continue
                prop = dict(best.values)
                prop[name] = int(mid) if is_int else mid
                proposals.append(prop)
        # Dedupe while preserving order.
        seen, uniq = set(), []
        for p in proposals:
            k = tuple(sorted((n, repr(v)) for n, v in p.items()))
            if k not in seen:
                seen.add(k)
                uniq.append(p)
        ref_cells = [experiment.cell_for(p) for p in uniq]
        search.evaluate(ref_cells, seed_list, round_id)
        order = _rank(search, ref_cells, objective, mode, check)
        new_best = ref_cells[order[0]]
        for name in brackets:
            x_old = float(best.values[name])
            x_new = float(new_best.values[name])
            if x_new != x_old:
                lo, hi = brackets[name]
                # The winner moved to a midpoint: the old incumbent becomes
                # one bound, the untouched bound tightens to the midpoint's
                # far side.
                brackets[name] = ((lo, x_old) if x_new < x_old
                                  else (x_old, hi))
            else:
                # Incumbent held: shrink toward it from both sides.
                lo, hi = brackets[name]
                brackets[name] = (
                    None if lo is None else (x_old + lo) / 2.0,
                    None if hi is None else (x_old + hi) / 2.0)
        best = new_best

    mm = search.mean_metrics(best)
    feasible = check(mm) if check is not None else True
    report = search.report(meta={
        "experiment": experiment.name, "objective": objective, "mode": mode,
        "constraint": repr(constraint) if constraint is not None else None,
        "seeds": ["-" if s is None else int(s) for s in seed_list],
        "eta": eta, "refine": refine, "n_evals": search.n_evals,
        "best": best.labels, "feasible": bool(feasible),
    })
    return TuneResult(
        best=dict(best.values), best_labels=dict(best.labels),
        best_metrics=mm, best_value=mm[objective], objective=objective,
        mode=mode, feasible=bool(feasible), report=report,
        n_evals=search.n_evals)
