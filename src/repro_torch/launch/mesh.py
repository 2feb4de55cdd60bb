"""Device meshes over the ranks of a ``torch.distributed`` world (the port
of ``repro/launch/mesh.py``).

JAX's mesh is an array of the devices one program sees; the port's is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one card (or one CPU process) a rank.  ``init_world`` starts a
world of one rank when no process group is running, so the entry points
work in a single process as JAX's do on the local devices; a world of
several ranks is started by its launcher, each rank calling
``torch.distributed.init_process_group`` with its own rank.  The backend
follows the device: NCCL for ``cuda``, gloo for ``cpu``.  Nothing falls
back: a card whose NCCL does not start raises.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..api.scenario import resolve_device

#: Mesh shapes of one pod (16 x 16 = 256 chips) and of two pods (512).
POD_SHAPE = ((16, 16), ("data", "model"))
MULTI_POD_SHAPE = ((2, 16, 16), ("pod", "data", "model"))


def init_world(device=None) -> bool:
    """Start a process group of one rank on ``device`` (default: the card)
    if none is running: NCCL on ``cuda``, gloo on ``cpu``, over a
    ``FileStore`` in a fresh temporary directory (no socket).  Returns
    True if it started one (the caller ends it with :func:`close_world`).

    A running group must suit the device: a ``cuda`` mesh needs NCCL."""
    dev = resolve_device(device)
    if dist.is_initialized():
        backend = str(dist.get_backend())
        if dev.type == "cuda" and "nccl" not in backend:
            raise RuntimeError(f"a cuda mesh needs the nccl backend; the "
                               f"running process group is {backend!r}")
        return False
    d = tempfile.mkdtemp(prefix="repro_world_")
    atexit.register(shutil.rmtree, d, True)
    store = dist.FileStore(os.path.join(d, "store"), 1)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return True


def close_world() -> None:
    """End the process group, if one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _make_mesh(shape, names, device):
    dev = resolve_device(device)
    init_world(dev)
    n, need = dist.get_world_size(), math.prod(shape)
    if n < need:
        # jax.make_mesh's refusal without the devices
        raise ValueError(f"Number of ranks {n} must be >= the product of "
                         f"mesh_shape {tuple(shape)}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 ``("data", "model")`` (one pod, 256 ranks) or 2 x 16 x 16
    ``("pod", "data", "model")`` (two pods, 512)."""
    shape, names = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    return _make_mesh(shape, names, device)


def make_host_mesh(model: int = 1, *, device=None):
    """A ``("data", "model")`` mesh of ``(max(n // model, 1), model)`` over
    the world's ``n`` ranks (a world of one is started if none runs)."""
    dev = resolve_device(device)
    init_world(dev)
    n = dist.get_world_size()
    return _make_mesh((max(n // model, 1), model), ("data", "model"), dev)
