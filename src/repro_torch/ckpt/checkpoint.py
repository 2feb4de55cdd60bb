"""Checkpoints with async save, atomic commit and restore-latest (the port
of ``repro/ckpt/checkpoint.py``), in the JAX package's on-disk layout:

    <dir>/step_<N>/meta.json     step, leaf paths, dtypes, shapes
    <dir>/step_<N>/arrays.npz    leaves a0, a1, ... (bfloat16 as uint16)
    <dir>/step_<N>.tmp/          staging (atomic rename on commit)
    <dir>/LATEST                 the last committed step

Leaves are written in ``jax.tree`` order with JAX's path strings
(``.params/blocks/attn/wq``, ``.opt/.count``, ...), so each package reads
the other's checkpoints of the same model: JAX by leaf order, the port by
``meta["paths"]``.  A save copies every leaf to host memory first and
writes from a background thread when asked; the mesh re-placement of
JAX's ``restore_latest`` (``shardings``) has no counterpart on one card.
The EETT-throttled shard writer is ``tuned_writer.py``
(:class:`TunedCheckpointWriter`), which stores leaves as :func:`_host`
does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..tree import leaves_with_paths, unflatten_like

_BF16 = "bfloat16"


def _host(t):
    """(numpy array as stored, dtype name) of one leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, state, *, blocking: bool = True,
         _done_cb=None) -> Optional[threading.Thread]:
    """Serialize ``state`` (a tree of tensors). blocking=False -> a
    background thread does the writing."""
    pairs = leaves_with_paths(state)
    host = [_host(x) for _, x in pairs]

    def _write():
        d_tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        d_fin = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(d_tmp, exist_ok=True)
        np.savez(os.path.join(d_tmp, "arrays.npz"),
                 **{f"a{i}": a for i, (a, _) in enumerate(host)})
        meta = {"step": step, "paths": [p for p, _ in pairs],
                "dtypes": [dt for _, dt in host],
                "shapes": [list(a.shape) for a, _ in host]}
        with open(os.path.join(d_tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(d_fin):
            shutil.rmtree(d_fin)
        os.rename(d_tmp, d_fin)                      # atomic commit
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
        if _done_cb:
            _done_cb(step)

    os.makedirs(ckpt_dir, exist_ok=True)
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def available_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def _load_step(ckpt_dir: str, step: int, like):
    """The checkpoint of ``step`` as a tree shaped like ``like``, each leaf
    found by its path and given ``like``'s dtype and device."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    index = {p: i for i, p in enumerate(meta["paths"])}
    want = leaves_with_paths(like)
    if len(index) != len(want):
        raise ValueError(f"checkpoint step {step} holds {len(index)} leaves, "
                         f"the state {len(want)}")
    out = {}
    for path, ref in want:
        i = index[path]
        a = data[f"a{i}"]
        if list(a.shape) != list(ref.shape):
            raise ValueError(f"checkpoint leaf {path}: shape {a.shape}, "
                             f"state {tuple(ref.shape)}")
        t = torch.from_numpy(np.array(a))
        if meta["dtypes"][i] == _BF16:
            t = t.view(torch.int16).view(torch.bfloat16)
        out[path] = t.to(device=ref.device, dtype=ref.dtype)
    return unflatten_like(like, [out[p] for p, _ in want]), meta["step"]


def restore_latest(ckpt_dir: str, like):
    """Restore the newest intact checkpoint: (state, step), or (None, -1)
    if there is none.  ``like``: a state of the same structure (e.g. a
    freshly initialised one), whose dtypes and devices the leaves take."""
    for step in reversed(available_steps(ckpt_dir)):
        try:
            return _load_step(ckpt_dir, step, like)
        except Exception:
            continue   # damaged checkpoint: fall back to the previous one
    return None, -1


class AsyncCheckpointer:
    """Keeps at most one save in flight; drops the request if still busy."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved = -1

    def maybe_save(self, step: int, state) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False

        def done(s):
            self.last_saved = s
            self._gc()
        self._thread = save(self.ckpt_dir, step, state, blocking=False,
                            _done_cb=done)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()

    def final_save(self, step: int, state) -> None:
        """Blocking save that is never dropped (end-of-run commit):
        drain, save, drain."""
        self.wait()
        if self.last_saved != step:
            self.maybe_save(step, state)
            self.wait()

    def _gc(self):
        steps = available_steps(self.ckpt_dir)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
