"""Lane-batch sharding helpers: a split of the lane axis over torch devices.

The JAX package's ``repro.distributed.sharding`` shards an engine lane
batch over a 1-D ``batch`` mesh of local devices (``batch_mesh``,
``pad_batch``, ``shard_batch``, ``MeshConfig``).  Here a mesh is the tuple
of torch devices itself and a sharded batch is one contiguous slice of the
lane axis per device, each moved to its device: lanes are independent, so
the devices run their slices with no communication, and the caller
concatenates the results in device order.

Batches are trees of arrays with a leading lane axis: tuples, lists,
NamedTuples or dicts of numpy arrays (or tensors).  The parameter
partitioning of the model stack (``param_specs`` and the rest of the JAX
module) is later work (ROADMAP queue 1, item 9e).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of tuples, lists, NamedTuples and
    dicts (and the matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def local_devices() -> tuple:
    """The CUDA devices this process sees; raises without a card (nothing
    moves to the CPU by itself: pass CPU devices explicitly)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass the devices "
                           "explicitly (e.g. (torch.device('cpu'),))")
    return tuple(torch.device("cuda", i) for i in range(n))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The lane-batch mesh of a fleet as ``num_hosts`` processes of
    ``devices_per_host`` cards each, flattened into one tuple of devices.

    ``devices_per_host=None`` means every visible card (one host).
    :meth:`devices` validates the request against the cards the process
    sees: asking for more raises rather than running on fewer.
    """

    num_hosts: int = 1
    devices_per_host: Optional[int] = None

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if self.devices_per_host is not None and self.devices_per_host < 1:
            raise ValueError(f"devices_per_host must be >= 1, got "
                             f"{self.devices_per_host}")

    @property
    def mesh_size(self) -> Optional[int]:
        if self.devices_per_host is None:
            return None
        return self.num_hosts * self.devices_per_host

    def devices(self) -> tuple:
        """The flattened (hosts x devices_per_host) device tuple, validated
        against :func:`local_devices`."""
        avail = local_devices()
        want = self.mesh_size
        if want is None:
            return avail
        if want > len(avail):
            raise ValueError(
                f"MeshConfig wants {self.num_hosts} hosts x "
                f"{self.devices_per_host} devices = {want}, but only "
                f"{len(avail)} devices are visible")
        return avail[:want]

    def mesh(self) -> tuple:
        """The 1-D mesh over :meth:`devices`."""
        return batch_mesh(self.devices())


def batch_mesh(devices=None) -> tuple:
    """The 1-D lane mesh: a tuple of torch devices (default: every visible
    card)."""
    devices = local_devices() if devices is None else devices
    return tuple(torch.device(d) for d in devices)


def pad_batch(tree, multiple: int, *, fill: str = "repeat"):
    """Pad axis 0 of every leaf up to a multiple of ``multiple``.

    Returns ``(padded_tree, original_batch_size)``; callers slice results
    back to the original size.  ``fill`` selects the padding rows:

    * ``"repeat"`` (default) repeats the last row.
    * ``"zero"`` appends zero rows — what the fleet wants: a zeroed engine
      lane has no bytes remaining, so it is born drained and frozen from
      its first tick, costing nothing.
    """
    if fill not in ("repeat", "zero"):
        raise ValueError(f"unknown fill mode {fill!r}")
    sizes = {np.shape(leaf)[0] for leaf in _leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes in tree: {sizes}")
    b = sizes.pop()
    pad = (-b) % multiple
    if pad == 0:
        return tree, b
    if fill == "zero":
        return _map(
            lambda x: np.concatenate(
                [x, np.zeros((pad,) + np.shape(x)[1:], np.asarray(x).dtype)]),
            tree), b
    return _map(
        lambda x: np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]),
        tree), b


def split_batch(tree, n: int) -> list:
    """``n`` trees of equal contiguous slices of axis 0 (which ``n`` must
    divide: pad with :func:`pad_batch` first)."""
    b = np.shape(_leaves(tree)[0])[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split over {n} devices; "
                         f"pad it with pad_batch first")
    k = b // n
    return [_map(lambda x, i=i: x[i * k:(i + 1) * k], tree) for i in range(n)]


def shard_batch(tree, mesh: tuple) -> list:
    """Place a lane batch on ``mesh``: one contiguous slice of axis 0 per
    device, as tensors on that device."""
    return [_map(lambda x, d=d: torch.as_tensor(x).to(d), part)
            for d, part in zip(mesh, split_batch(tree, len(mesh)))]
