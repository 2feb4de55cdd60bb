"""Fault-tolerant training loop (the port of ``repro/train/trainer.py``).

  * checkpoint/restart: async atomic checkpoints + restore-latest on boot;
  * straggler mitigation: per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x the EWMA are counted and trigger an immediate
    checkpoint, so a kill loses little work;
  * SLA-tuned ingest: the data pipeline's fetch stage runs the paper's
    controller (:class:`repro_torch.data.TunedFetcher`).

The state lives on ``device`` (the card unless told otherwise); each batch
is moved there before its step, and a step's wall time ends when its loss
is read back.  A caller may hand in its own ``state`` -- one placed on a
mesh (``train.step.place_state``, ``init_train_state(mesh=...)``) takes
the placed step (partitioned for the dense family, data-parallel for the
others), every rank fed the same global batches.  Checkpoints of a placed
state hold its whole leaves, on a mesh of one rank only (a mesh of
several would need every rank to decide each save alike; ROADMAP queue
1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

from ..api.scenario import resolve_device
from ..ckpt import AsyncCheckpointer, restore_latest
from ..distributed import sharding
from ..models import ModelBundle
from ..optim import AdamWConfig
from ..tree import leaves
from .step import TrainState, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    microbatches: int = 1
    moe_impl: str = "gmm"
    seed: int = 0


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    restored_from: int
    straggler_steps: int
    losses: list


def train(bundle: ModelBundle, opt_cfg: AdamWConfig, data: Iterator[dict],
          tcfg: TrainerConfig, *, hooks: Optional[Callable] = None,
          device=None, state: Optional[TrainState] = None
          ) -> tuple[TrainState, TrainReport]:
    dev = resolve_device(device)
    if state is None:
        state = init_train_state(bundle, tcfg.seed, device=dev)
    placed = sharding.is_placed(leaves(state.params)[0])

    def host(st):
        """What a checkpoint holds: the whole leaves."""
        return sharding.gather_full(st) if placed else st

    restored_from = -1
    ckpt = None
    if tcfg.ckpt_dir:
        if placed and leaves(state.params)[0].device_mesh.mesh.numel() > 1:
            raise NotImplementedError(
                "checkpoints of a state placed over several ranks: ROADMAP "
                "item 9g.5 (one rank's mesh, or no mesh, checkpoints)")
        ckpt = AsyncCheckpointer(tcfg.ckpt_dir)
        restored, rstep = restore_latest(tcfg.ckpt_dir, host(state))
        if restored is not None:
            if placed:
                restored = sharding.place_like(restored, state)
            state, restored_from = restored, rstep

    step_fn = make_train_step(bundle, opt_cfg, moe_impl=tcfg.moe_impl,
                              microbatches=tcfg.microbatches)

    ewma = None
    stragglers = 0
    losses = []
    start_step = int(state.step)
    for i in range(start_step, tcfg.total_steps):
        batch = {k: v.to(dev) for k, v in next(data).items()}
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0

        if ewma is None:
            ewma = dt
        else:
            if dt > tcfg.straggler_factor * ewma and i > start_step + 2:
                stragglers += 1
                if ckpt:
                    ckpt.maybe_save(i + 1, host(state))   # protect progress
            ewma = 0.9 * ewma + 0.1 * dt

        losses.append(loss)
        if tcfg.log_every and (i + 1) % tcfg.log_every == 0:
            print(f"step {i+1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms")
        if ckpt and (i + 1) % tcfg.ckpt_every == 0:
            ckpt.maybe_save(i + 1, host(state))
        if hooks:
            hooks(i, state, metrics)

    if ckpt:
        ckpt.final_save(tcfg.total_steps, host(state))

    report = TrainReport(
        steps_run=tcfg.total_steps - start_step,
        final_loss=losses[-1] if losses else float("nan"),
        restored_from=restored_from,
        straggler_steps=stragglers,
        losses=losses,
    )
    return state, report
