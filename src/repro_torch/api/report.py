"""Report: a columnar, numpy-backed results table for experiment grids (the
port of ``repro/api/report.py``: host numpy, the same schema, so a Report
written by either package loads in the other).

The paper's results are all grids — tools x testbeds x datasets evaluated on
energy and throughput — so results deserve a first-class table, not a bare
list of :class:`~repro_torch.core.engine.TransferResult` scalars.  A Report holds
one row per experiment cell: the cell's axis *labels* (string columns) plus
its scalar *metrics* (float64 columns), with the derived metrics the paper
reports computed once at construction:

* ``gb``             — gigabytes actually moved
* ``joules_per_gb``  — energy over bytes moved (the paper's efficiency axis)
* ``edp``            — energy-delay product, ``energy_j * time_s``
* ``*_vs_<label>``   — percent difference vs a designated baseline axis
                       value (:meth:`vs_baseline`)

Everything is pandas-free: columns are plain numpy arrays (``object`` dtype
for labels, ``float64`` for metrics), and ``to_json``/``from_json``
round-trip bit-exactly (Python's ``json`` serializes floats via ``repr``,
the shortest round-tripping form).
"""
from __future__ import annotations

import json
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np

SCHEMA = "repro.report/v1"

# Scalar fields lifted off each TransferResult, in column order.
RESULT_METRICS = ("completed", "time_s", "energy_j", "avg_tput_MBps",
                  "avg_tput_gbps", "avg_power_w")


def derive_row(metrics: dict) -> dict:
    """Row-wise view of the derived columns — the same ``_derive``
    formulas applied to a scalar record (np ops accept scalars), results
    normalized back to python floats."""
    return {k: float(v) for k, v in _derive(metrics).items()}


def _derive(cols: dict) -> dict:
    """Add the derived metric columns (idempotent; never overwrites)."""
    out = dict(cols)
    if "moved_mb" not in out and {"avg_tput_MBps", "time_s"} <= set(out):
        out["moved_mb"] = out["avg_tput_MBps"] * out["time_s"]
    if "moved_mb" in out:
        out.setdefault("gb", out["moved_mb"] / 1024.0)
    if "gb" in out and "energy_j" in out:
        out.setdefault("joules_per_gb",
                       out["energy_j"] / np.maximum(out["gb"], 1e-9))
    if {"energy_j", "time_s"} <= set(out):
        out.setdefault("edp", out["energy_j"] * out["time_s"])
    return out


class Report:
    """One row per experiment cell: axis labels + scalar metrics.

    ``axes`` columns hold strings (cell labels), ``metrics`` columns hold
    float64 (``completed`` is stored as 0.0/1.0 so every metric column
    supports the same aggregation path).  Construction order is preserved;
    all views (:meth:`select`, :meth:`group_by`, :meth:`vs_baseline`)
    return new Reports and never mutate.
    """

    def __init__(self, columns: Mapping[str, Sequence], *,
                 axes: Sequence[str], meta: Optional[dict] = None,
                 derive: bool = True):
        cols: dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            if name in axes:
                arr = np.asarray(values, dtype=object)
            else:
                if not isinstance(values, np.ndarray):
                    # None (how to_dict spells NaN, and how fleet percentile
                    # rows spell "no completed transfers") loads as NaN.
                    values = [np.nan if v is None else v for v in values]
                arr = np.asarray(values, dtype=np.float64)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(f"column {name!r} has {len(arr)} rows, "
                                 f"expected {n}")
            cols[name] = arr
        missing = [a for a in axes if a not in cols]
        if missing:
            raise ValueError(f"axes {missing} have no column")
        metric_cols = {k: v for k, v in cols.items() if k not in axes}
        if derive:
            metric_cols = _derive(metric_cols)
        self._cols = {**{a: cols[a] for a in axes}, **metric_cols}
        self.axes = tuple(axes)
        self.metrics = tuple(k for k in self._cols if k not in self.axes)
        self.meta = dict(meta or {})

    # ------------------------------------------------------------ basics --

    def __len__(self) -> int:
        first = next(iter(self._cols.values()), None)
        return 0 if first is None else len(first)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(self._cols)

    def rows(self) -> list[dict]:
        """Materialize as a list of per-row dicts (labels + python floats)."""
        out = []
        for i in range(len(self)):
            row = {}
            for name, col in self._cols.items():
                v = col[i]
                row[name] = v if name in self.axes else float(v)
            out.append(row)
        return out

    def row(self, i: int) -> dict:
        return {name: (col[i] if name in self.axes else float(col[i]))
                for name, col in self._cols.items()}

    # ------------------------------------------------------------- views --

    def _take(self, idx: np.ndarray, *, meta: Optional[dict] = None
              ) -> "Report":
        cols = {name: col[idx] for name, col in self._cols.items()}
        return Report(cols, axes=self.axes, meta=meta or self.meta,
                      derive=False)

    def select(self, **where) -> "Report":
        """Filter rows.  Keyword values are compared by equality; a callable
        value is used as a per-element predicate::

            report.select(testbed="chameleon", tool="EEMT")
            report.select(energy_j=lambda e: e < 100.0)
        """
        mask = np.ones(len(self), dtype=bool)
        for name, want in where.items():
            col = self._cols[name]
            if callable(want):
                mask &= np.array([bool(want(v)) for v in col])
            else:
                mask &= (col == want)
        return self._take(np.flatnonzero(mask))

    def group_by(self, *by: str, agg: str = "mean",
                 metrics: Optional[Iterable[str]] = None) -> "Report":
        """Aggregate metric columns over groups of identical ``by`` labels.

        ``agg`` is one of mean/sum/min/max; groups keep first-appearance
        order.  The result's axes are exactly ``by`` and its metrics carry
        the aggregate (plus an ``n`` count column).
        """
        fn = {"mean": np.mean, "sum": np.sum,
              "min": np.min, "max": np.max}[agg]
        metrics = tuple(metrics) if metrics is not None else self.metrics
        # "n" is this method's own count column: aggregating a previously
        # grouped Report must not emit it twice.
        metrics = tuple(m for m in metrics if m != "n")
        keys = list(zip(*(self._cols[b] for b in by))) if by else []
        order: list[tuple] = []
        groups: dict[tuple, list[int]] = {}
        for i, k in enumerate(keys):
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(i)
        cols: dict[str, list] = {b: [] for b in by}
        cols.update({m: [] for m in metrics})
        cols["n"] = []
        for k in order:
            idx = groups[k]
            for b, label in zip(by, k):
                cols[b].append(label)
            for m in metrics:
                cols[m].append(float(fn(self._cols[m][idx])))
            cols["n"].append(float(len(idx)))
        return Report(cols, axes=by, meta=dict(self.meta, grouped_by=list(by),
                                               agg=agg), derive=False)

    def vs_baseline(self, axis: str, baseline: str,
                    metrics: Optional[Iterable[str]] = None) -> "Report":
        """Add ``<metric>_vs_<baseline>`` percent-difference columns.

        For each row, the reference is the row holding ``baseline`` on
        ``axis`` and identical labels on every *other* axis (the designated
        baseline cell of its grid slice).  Positive means higher than the
        baseline.  Baseline rows themselves read 0.0; slices with no
        baseline cell get NaN.
        """
        metrics = tuple(metrics) if metrics is not None else \
            tuple(m for m in ("energy_j", "avg_tput_gbps", "time_s",
                              "joules_per_gb") if m in self._cols)
        others = tuple(a for a in self.axes if a != axis)
        ref: dict[tuple, int] = {}
        for i in np.flatnonzero(self._cols[axis] == baseline):
            ref[tuple(self._cols[a][i] for a in others)] = int(i)
        cols = {name: col.copy() for name, col in self._cols.items()}
        for m in metrics:
            out = np.full(len(self), np.nan)
            for i in range(len(self)):
                j = ref.get(tuple(self._cols[a][i] for a in others))
                if j is not None:
                    base = self._cols[m][j]
                    out[i] = 100.0 * (self._cols[m][i] / base - 1.0) \
                        if base != 0.0 else np.nan
            cols[f"{m}_vs_{baseline}"] = out
        return Report(cols, axes=self.axes,
                      meta=dict(self.meta, baseline={axis: baseline}),
                      derive=False)

    def argbest(self, metric: str, *, mode: str = "min",
                where: Optional[Callable[[dict], bool]] = None) -> dict:
        """The row optimizing ``metric`` (optionally among rows passing
        ``where``); raises ValueError when no row qualifies."""
        vals = self._cols[metric]
        best_i, best_v = None, None
        for i in range(len(self)):
            if where is not None and not where(self.row(i)):
                continue
            v = float(vals[i])
            if best_i is None or (v < best_v if mode == "min" else v > best_v):
                best_i, best_v = i, v
        if best_i is None:
            raise ValueError(f"no row satisfies the constraint "
                             f"(of {len(self)} rows)")
        return self.row(best_i)

    # ------------------------------------------------------------- table --

    def table(self, columns: Optional[Sequence[str]] = None,
              float_fmt: str = "{:.3f}") -> str:
        """Plain-text table (for logs and examples; not part of the schema)."""
        names = tuple(columns) if columns is not None else self.columns
        rows = [[name for name in names]]
        for i in range(len(self)):
            rows.append([str(self._cols[n][i]) if n in self.axes
                         else float_fmt.format(float(self._cols[n][i]))
                         for n in names])
        widths = [max(len(r[c]) for r in rows) for c in range(len(names))]
        lines = ["  ".join(cell.ljust(w) for cell, w in zip(r, widths))
                 for r in rows]
        lines.insert(1, "  ".join("-" * w for w in widths))
        return "\n".join(lines)

    # ------------------------------------------------------- persistence --

    def to_dict(self) -> dict:
        """JSON-ready payload (the Report schema)."""
        cols = {}
        for name, col in self._cols.items():
            if name in self.axes:
                cols[name] = [str(v) for v in col]
            else:
                # NaN serializes as null: json.dumps would otherwise emit a
                # bare NaN literal that strict JSON parsers reject.
                cols[name] = [None if v != v else float(v) for v in col]
        # "metrics" pins column order: json.dumps(sort_keys=True) reorders
        # the columns mapping, and axes+metrics restores it on load.
        return {"schema": SCHEMA, "axes": list(self.axes),
                "metrics": list(self.metrics), "meta": self.meta,
                "columns": cols}

    def to_json(self, path: Optional[str] = None) -> str:
        """Serialize; floats round-trip bit-exactly through ``from_json``."""
        text = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    @classmethod
    def from_dict(cls, payload: Mapping) -> "Report":
        if payload.get("schema") != SCHEMA:
            raise ValueError(f"not a Report payload "
                             f"(schema={payload.get('schema')!r}, "
                             f"expected {SCHEMA!r})")
        axes = tuple(payload["axes"])
        cols = payload["columns"]
        order = list(axes) + [m for m in payload.get("metrics", [])
                              if m in cols]
        order += [c for c in cols if c not in order]
        return cls({name: cols[name] for name in order}, axes=axes,
                   meta=dict(payload.get("meta", {})), derive=False)

    @classmethod
    def from_json(cls, text_or_path: str) -> "Report":
        """Inverse of :meth:`to_json`; accepts a JSON string or a path."""
        text = text_or_path
        if not text_or_path.lstrip().startswith("{"):
            with open(text_or_path) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_rows(cls, rows: Iterable[Mapping], *, axes: Sequence[str],
                  meta: Optional[dict] = None,
                  derive: bool = True) -> "Report":
        """Build incrementally from an iterable of row dicts.

        The streaming-friendly constructor: ``rows`` may be any iterable
        (a generator folding results as they retire — e.g. the online
        fleet's per-controller rows), consumed once, appended column-wise.
        Axis fields load as labels, everything else as float64 metrics
        (``None`` → NaN, exactly like the mapping constructor).  Every row
        must carry the same keys — a missing metric mid-stream raises
        rather than silently misaligning columns.
        """
        axes = tuple(axes)
        cols: dict[str, list] = {}
        names: Optional[tuple] = None
        for i, row in enumerate(rows):
            if names is None:
                names = tuple(row)
                missing = [a for a in axes if a not in names]
                if missing:
                    raise ValueError(f"axes {missing} missing from rows")
                cols = {name: [] for name in names}
            elif set(row) != set(names):
                raise ValueError(
                    f"row {i} keys {sorted(row)} != first row's "
                    f"{sorted(names)}")
            for name in names:
                v = row[name]
                cols[name].append(str(v) if name in axes else v)
        if names is None:              # empty iterable: zero-row report
            cols = {a: [] for a in axes}
        return cls(cols, axes=axes, meta=meta, derive=derive)

    @classmethod
    def from_results(cls, labels: Sequence[Mapping[str, str]],
                     results: Sequence, *, axes: Sequence[str],
                     meta: Optional[dict] = None) -> "Report":
        """Build from per-cell label dicts + TransferResult-like records.

        ``results`` entries need the :data:`RESULT_METRICS` attributes (a
        ``TransferResult`` or any scalar record object/mapping).
        """
        if len(labels) != len(results):
            raise ValueError(f"{len(labels)} label rows vs "
                             f"{len(results)} results")
        cols: dict[str, list] = {a: [] for a in axes}
        cols.update({m: [] for m in RESULT_METRICS})
        for lab, res in zip(labels, results):
            for a in axes:
                cols[a].append(str(lab[a]))
            for m in RESULT_METRICS:
                v = res[m] if isinstance(res, Mapping) else getattr(res, m)
                cols[m].append(float(v))
        return cls(cols, axes=axes, meta=meta)
