"""Carry state between the JAX package and this port.

The JAX package's host-side values are numpy: ``ScanInputs`` after
``repro.api.scenario._prepare`` (``.inputs``), ``SimState`` / ``TunerState``
rows, the packed ``TickLayout`` rows.  :func:`to_torch` turns such a value —
an array, or a NamedTuple of them, nested — into the port's tensors on the
device the caller picks, mapping each NamedTuple to the port's class of the
same name (``repro_torch.core`` types and the engine's ``ScanInputs``).
:func:`to_numpy` goes the other way, to numpy leaves (optionally rebuilt as
a caller-given NamedTuple class, e.g. one of the JAX package's).  Values are
copied bit for bit; nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import engine, network_model, tuners, types

_PORT_TYPES = {cls.__name__: cls for cls in (
    types.NetParams, types.SLAParams, types.TransferParams, types.SimState,
    types.TunerState, types.TickMetrics, engine.ScanInputs,
    tuners.Measurement, network_model.NetOut)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(x, device=None):
    """numpy leaves (or a NamedTuple of them, nested) -> tensors on
    ``device`` (default: the CPU), in the port's NamedTuple classes."""
    if _is_namedtuple(x):
        cls = _PORT_TYPES.get(type(x).__name__, type(x))
        return cls(*[to_torch(v, device) for v in x])
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.array(x), device=device)


def to_numpy(x, like=None):
    """Tensors (or a NamedTuple of them, nested) -> numpy leaves.  ``like``
    names the NamedTuple class to rebuild the top level as (fields by
    position)."""
    if _is_namedtuple(x):
        vals = [to_numpy(v) for v in x]
        return (like or type(x))(*vals)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
