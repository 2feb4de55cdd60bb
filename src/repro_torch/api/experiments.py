"""Declarative experiment grids over Scenario fields (the port of
``repro/api/experiments.py``).

The paper's figures are all grids — tools x testbeds x datasets — and every
benchmark used to hand-roll the same three steps: enumerate cells, call
``sweep``, zip results back to labels.  An :class:`Experiment` makes the
grid itself the object:

    >>> exp = Experiment(
    ...     name="fig2",
    ...     space=grid(axis("testbed", TESTBEDS, field="profile"),
    ...                axis("dataset", DATASETS, field="datasets"),
    ...                axis("tool", TOOLS)),
    ...     base={"cpu": CpuProfile(),
    ...           "controller": lambda c: c["tool"],
    ...           "total_s": lambda c: budget_for(c["profile"])})
    >>> report = exp.run()

Axes bind Scenario fields (``field=``) or stay pure metadata consumed by
callable ``base`` entries, which receive the cell's value dict.  Spaces
compose: :func:`grid` is the cartesian product, :func:`zip_` advances axes
in lockstep (one composite axis), :func:`chain` concatenates sub-spaces
(for grids with an irregular corner, e.g. fig4's static baselines that have
no ``scaling`` axis).

``Experiment.run`` executes every cell through :func:`repro_torch.api.sweep` —
one lane batch per code group, one kernel launch each on a card — and returns a
:class:`~repro_torch.api.report.Report`.  With ``cache=<dir>`` each cell's scalar
result is persisted under a content hash of its *resolved scenario*
(profiles, datasets, controller config, environment code, horizon — not
object identity), so re-running an unchanged grid performs zero sweep
calls and a partially-cached grid re-executes only the missing cells.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
import time
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np

from .report import RESULT_METRICS, Report
from .scenario import Scenario, sweep

# Bump when engine semantics change in a way that invalidates cached cell
# results (the hash covers the scenario spec, not the simulator code).  It
# is the JAX package's tag, so a scenario's key is the same in both
# packages.  Every record also names the package that wrote it, and a
# record of the other package is a miss: the port follows JAX's op-by-op
# float32 semantics, jitted JAX does not, so one cache directory may serve
# both without either returning the other's numbers as its own.
CACHE_VERSION = "repro-cells/v1"
CACHE_PACKAGE = "repro_torch"

_SCENARIO_FIELDS = tuple(f.name for f in dataclasses.fields(Scenario))


# ----------------------------------------------------------- fingerprints --

def _canonical(obj) -> Any:
    """Recursively reduce ``obj`` to JSON-serializable canonical structure.

    Dataclasses become ``[classname, [field, value]...]``, enums their
    class+name, arrays a digest of shape/dtype/bytes — so two scenarios
    that would simulate identically hash identically, regardless of object
    identity.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return repr(obj)            # shortest round-trip form, bit-exact
    if isinstance(obj, enum.Enum):
        return [type(obj).__name__, obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [type(obj).__name__,
                [[f.name, _canonical(getattr(obj, f.name))]
                 for f in dataclasses.fields(obj)]]
    if isinstance(obj, np.ndarray):
        return ["ndarray", str(obj.dtype), list(obj.shape),
                hashlib.sha256(np.ascontiguousarray(obj).tobytes())
                .hexdigest()]
    if isinstance(obj, np.generic):
        return _canonical(obj.item())
    if isinstance(obj, (tuple, list)):
        return [_canonical(x) for x in obj]
    if isinstance(obj, Mapping):
        return [[k, _canonical(v)] for k, v in sorted(obj.items())]
    if hasattr(obj, "code") and callable(obj.code) and hasattr(obj, "name"):
        # Non-dataclass Controller/Environment implementations: code() is
        # their own compiled-identity contract; name covers the label.
        return [type(obj).__name__, str(obj.name), repr(obj.code())]
    raise TypeError(f"cannot fingerprint {type(obj).__name__} for the "
                    f"experiment cache; use dataclasses / arrays / "
                    f"primitives (or objects with .code()/.name)")


def fingerprint(obj) -> str:
    """Content hash (sha256 hex) of any canonicalizable object."""
    payload = json.dumps([CACHE_VERSION, _canonical(obj)],
                         separators=(",", ":"), sort_keys=False)
    return hashlib.sha256(payload.encode()).hexdigest()


def scenario_key(sc: Scenario) -> str:
    """Content hash of everything that determines a scenario's result.

    Controller / environment spellings are normalized first (a registry
    name and the instance it builds hash identically); ``name`` is label
    metadata and excluded.
    """
    from .controllers import as_controller
    from .environments import as_environment

    spec = []
    for f in _SCENARIO_FIELDS:
        if f == "name":
            continue
        v = getattr(sc, f)
        if f == "controller":
            v = as_controller(v)
        elif f == "environment":
            v = as_environment(v)
        spec.append([f, _canonical(v)])
    return fingerprint(spec)


# ------------------------------------------------------------------ axes --

def _safe_eq(a, b) -> bool:
    """Equality that never raises (array-valued axis values compare by
    identity only)."""
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


def _label_of(value) -> str:
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return str(value).lower()
    if isinstance(value, (int, float)):
        return f"{value:g}"
    name = getattr(value, "name", None)
    if isinstance(name, str):
        return name
    return type(value).__name__


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named dimension of an experiment: parallel labels and values.

    ``field`` names the Scenario field the axis binds; ``None`` makes the
    axis pure metadata (recorded in the Report, visible to callable
    ``base`` entries as ``cell[name]``).
    """

    name: str
    labels: tuple
    values: tuple
    field: Optional[str] = None

    def __post_init__(self):
        if len(self.labels) != len(self.values):
            raise ValueError(f"axis {self.name!r}: {len(self.labels)} "
                             f"labels vs {len(self.values)} values")
        if not self.values:
            raise ValueError(f"axis {self.name!r} is empty")
        if self.field is not None and self.field not in _SCENARIO_FIELDS:
            raise ValueError(f"axis {self.name!r} binds unknown Scenario "
                             f"field {self.field!r}")

    def cells(self) -> list[dict]:
        return [{self.name: (label, value, self.field)}
                for label, value in zip(self.labels, self.values)]

    def axis_names(self) -> tuple[str, ...]:
        return (self.name,)


def axis(name: str, values, field: Optional[str] = None) -> Axis:
    """Build an :class:`Axis`.

    ``values`` may be a mapping (labels are the keys), a sequence of
    ``(label, value)`` pairs, or a sequence of bare values (labels derived:
    strings/numbers verbatim, objects by their ``.name``).
    """
    if isinstance(values, Mapping):
        pairs = [(str(k), v) for k, v in values.items()]
    else:
        values = list(values)
        if values and all(isinstance(v, tuple) and len(v) == 2
                          and isinstance(v[0], str) for v in values):
            pairs = [(k, v) for k, v in values]
        else:
            pairs = [(_label_of(v), v) for v in values]
    return Axis(name=name, labels=tuple(p[0] for p in pairs),
                values=tuple(p[1] for p in pairs), field=field)


def _as_space(part) -> Union[Axis, "_Space"]:
    if isinstance(part, (Axis, _Space)):
        return part
    raise TypeError(f"expected an axis or space, got {type(part).__name__}")


class _Space:
    """Composite of axes: product, zip, or concatenation."""

    def __init__(self, kind: str, parts: tuple):
        self.kind = kind
        self.parts = parts

    def axis_names(self) -> tuple[str, ...]:
        names: list[str] = []
        for p in self.parts:
            for n in p.axis_names():
                if n not in names:
                    names.append(n)
        return tuple(names)

    def cells(self) -> list[dict]:
        part_cells = [p.cells() for p in self.parts]
        if self.kind == "grid":
            out = [{}]
            for cells in part_cells:
                out = [{**acc, **c} for acc in out for c in cells]
            return out
        if self.kind == "zip":
            lengths = {len(c) for c in part_cells}
            if len(lengths) > 1:
                raise ValueError(f"zip_ needs equal-length parts, got "
                                 f"{[len(c) for c in part_cells]}")
            return [{k: v for c in row for k, v in c.items()}
                    for row in zip(*part_cells)]
        if self.kind == "chain":
            return [c for cells in part_cells for c in cells]
        raise AssertionError(self.kind)


def _make_parts(parts, kw) -> tuple:
    made = [_as_space(p) for p in parts]
    made += [axis(name, values) for name, values in kw.items()]
    if not made:
        raise ValueError("a space needs at least one axis")
    return tuple(made)


def grid(*parts, **kw) -> _Space:
    """Cartesian product of axes/spaces.  Keyword shorthand:
    ``grid(tool=["ME", "EEMT"])`` == ``grid(axis("tool", [...]))``."""
    return _Space("grid", _make_parts(parts, kw))


def zip_(*parts, **kw) -> _Space:
    """Advance axes in lockstep (all must have the same length) — one
    composite axis, e.g. paired ``(profile, budget)`` columns."""
    return _Space("zip", _make_parts(parts, kw))


def chain(*parts) -> _Space:
    """Concatenate sub-spaces row-wise.  Axes missing from one sub-space
    appear with label ``""`` / value ``None`` in its cells — how fig4 mixes
    ``algo x scaling`` tuners with scaling-free static baselines."""
    return _Space("chain", _make_parts(parts, {}))


# ------------------------------------------------------------ experiment --

@dataclasses.dataclass(frozen=True)
class Cell:
    """One resolved grid point."""

    labels: dict                    # axis name -> label (str)
    values: dict                    # axis name -> raw axis value
    scenario: Scenario
    key: str                        # content hash (the cache key)

    def tag(self, prefix: str = "") -> str:
        path = "/".join(self.labels[a] for a in self.labels
                        if self.labels[a] != "")
        return f"{prefix}/{path}" if prefix else path


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A named grid of Scenarios, executed as one sweep, reported as a table.

    ``base`` supplies Scenario fields not bound by any axis; callable
    entries are resolved per cell against the cell's value dict (axis name
    -> raw value) — that is where cross-axis derivations live (a budget
    that depends on the profile, a controller built from two axes).  An
    axis binding a field always wins over ``base``.
    """

    name: str
    space: Union[Axis, _Space]
    base: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        unknown = set(self.base) - set(_SCENARIO_FIELDS)
        if unknown:
            raise ValueError(f"base has non-Scenario fields: "
                             f"{sorted(unknown)}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.space.axis_names()

    def cells(self) -> list[Cell]:
        names = self.axis_names
        out = []
        for raw in self.space.cells():
            labels = {n: raw[n][0] if n in raw else "" for n in names}
            values = {n: raw[n][1] if n in raw else None for n in names}
            out.append(self._build_cell(labels, values, raw))
        return out

    def _build_cell(self, labels: dict, values: dict, raw: dict) -> Cell:
        fields: dict[str, Any] = dict(self.base)
        # Callables see axis values under the axis name AND under the bound
        # Scenario field name (a budget rule reads c["profile"] without
        # caring that the axis is called "testbed").
        ctx = dict(values)
        for n, (_, value, field) in raw.items():
            if field is not None:
                fields[field] = value
                ctx.setdefault(field, value)
        resolved = {k: (v(ctx) if callable(v) else v)
                    for k, v in fields.items()}
        sc = Scenario(**resolved)
        if sc.name is None:
            sc = dataclasses.replace(
                sc, name="/".join([self.name] +
                                  [v for v in labels.values() if v != ""]))
        return Cell(labels=labels, values=values, scenario=sc,
                    key=scenario_key(sc))

    def cell_for(self, values: Mapping[str, Any]) -> Cell:
        """Build a single cell from explicit axis values (used by ``tune``'s
        grid-refine step, which evaluates off-grid points).

        A value that matches one of the axis's declared grid points keeps
        the declared label (``{"mixed": MIXED}`` stays ``"mixed"``, not a
        derived type name); off-grid values get a derived label.  ``None``
        means the axis is absent from this cell (how ``chain`` sub-spaces
        spell a missing axis): it stays metadata and never binds its field.
        """
        names = self.axis_names
        axes_by_name: dict[str, list[Axis]] = {}
        for a in _iter_axes(self.space):
            axes_by_name.setdefault(a.name, []).append(a)
        raw = {}
        for n in names:
            if n not in values:
                raise KeyError(f"missing value for axis {n!r}")
            v = values[n]
            if v is None:
                continue
            # A chain space may declare the same axis name in several
            # sub-spaces: search them all for the declared label.
            candidates = axes_by_name.get(n, [])
            label = None
            for ax in candidates:
                for lab, declared in zip(ax.labels, ax.values):
                    if declared is v or _safe_eq(declared, v):
                        label = lab
                        break
                if label is not None:
                    break
            field = next((a.field for a in candidates
                          if a.field is not None), None)
            raw[n] = (label if label is not None else _label_of(v), v, field)
        labels = {n: raw[n][0] if n in raw else "" for n in names}
        vals = {n: raw[n][1] if n in raw else None for n in names}
        return self._build_cell(labels, vals, raw)

    # ---------------------------------------------------------- running --

    def run(self, *, cache: Optional[str] = None, timing: str = "cold",
            sweeper: Optional[Callable] = None, meta: Optional[dict] = None,
            cells: Optional[list] = None, device=None) -> Report:
        """Execute the grid and return a :class:`Report` (row order = cell
        enumeration order).

        cache    directory for content-hash-keyed per-cell result records;
                 cached cells are served without executing (``resume`` is
                 implicit: only missing cells run).  ``None`` disables.
        timing   "cold" (default): one timed sweep over the missing cells.
                 "split": after the cold pass, run the same sweep again warm
                 and report steady-state per-cell time separately from the
                 first-call cost (``meta: wall_s / warm_wall_s / compile_s /
                 us_per_cell``).  In the port, ``compile_s`` is what the
                 first call pays once per process: building the CUDA
                 library with nvcc and loading it (nothing is compiled
                 per grid, as XLA compiles in the JAX package).
        sweeper  replaces :func:`repro_torch.api.sweep` (tests spy through
                 this); it is called with the list of scenarios alone.
        cells    precomputed ``self.cells()``, for callers that already
                 enumerated the grid (each cell carries a content hash;
                 re-enumerating repeats that work).
        device   where :func:`repro_torch.api.sweep` runs the cells
                 (``None``: the CUDA device, as everywhere in the port).
        """
        if timing not in ("cold", "split"):
            raise ValueError(f"timing must be 'cold' or 'split', "
                             f"got {timing!r}")
        if sweeper is not None:
            do_sweep = sweeper
        else:
            def do_sweep(scenarios):
                return sweep(scenarios, device=device)
        if cells is None:
            cells = self.cells()
        records: list[Optional[dict]] = [None] * len(cells)
        hits = 0
        if cache is not None:
            for i, cell in enumerate(cells):
                rec = _cache_read(cache, cell.key)
                if rec is not None:
                    records[i] = rec
                    hits += 1
        miss = [i for i, r in enumerate(records) if r is None]

        run_meta = {"experiment": self.name, "cells": len(cells),
                    "cache_hits": hits, "executed": len(miss)}
        if miss:
            t0 = time.perf_counter()
            results = do_sweep([cells[i].scenario for i in miss])
            wall_s = time.perf_counter() - t0
            run_meta["wall_s"] = wall_s
            if timing == "split":
                t0 = time.perf_counter()
                do_sweep([cells[i].scenario for i in miss])
                warm_s = time.perf_counter() - t0
                run_meta.update(
                    warm_wall_s=warm_s,
                    compile_s=max(wall_s - warm_s, 0.0),
                    us_per_cell=warm_s / len(miss) * 1e6)
            else:
                run_meta["us_per_cell"] = wall_s / len(miss) * 1e6
            for i, res in zip(miss, results):
                rec = {m: float(getattr(res, m)) for m in RESULT_METRICS}
                rec["name"] = res.name
                records[i] = rec
                if cache is not None:
                    _cache_write(cache, cells[i].key, rec)
        else:
            run_meta["wall_s"] = 0.0

        labels = [c.labels for c in cells]
        report = Report.from_results(labels, records, axes=self.axis_names,
                                     meta=dict(run_meta, **(meta or {})))
        return report


def _iter_axes(space) -> list[Axis]:
    if isinstance(space, Axis):
        return [space]
    out = []
    for p in space.parts:
        out.extend(_iter_axes(p))
    return out


# ----------------------------------------------------------------- cache --

def _cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{key}.json")


def _cache_read(cache_dir: str, key: str) -> Optional[dict]:
    path = _cache_path(cache_dir, key)
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if (payload.get("version") != CACHE_VERSION
            or payload.get("package") != CACHE_PACKAGE):
        return None
    return payload.get("record")


def _cache_write(cache_dir: str, key: str, record: dict) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    path = _cache_path(cache_dir, key)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": CACHE_VERSION, "package": CACHE_PACKAGE,
                   "record": record}, f)
    os.replace(tmp, path)           # atomic: a torn write never half-reads


def clear_cache(cache_dir: str) -> int:
    """Delete every cached cell record in ``cache_dir``; returns the count."""
    n = 0
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    for name in names:
        if name.endswith(".json"):
            try:
                os.remove(os.path.join(cache_dir, name))
                n += 1
            except OSError:
                pass
    return n
