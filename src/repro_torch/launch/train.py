"""Training launcher (the port of ``repro/launch/train.py``): on the card,
or on the CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 32

The flow is JAX's: mesh -> placed train state -> SLA-tuned ingest ->
fault-tolerant trainer.  The mesh is the host mesh of ``--tp`` model ranks
over the world (``launch/mesh.py``: a world of one rank is started when no
process group runs, and ended after), or with ``--production-mesh`` the
16 x 16 pod (2 x 16 x 16 with ``--multi-pod``), which needs 256 (512)
ranks.  Parameters are placed by ``param_specs`` and AdamW moments by
``zero_specs`` (``init_train_state(mesh=...)``: every rank makes the same
draws, a ``torch.Generator`` on its device with seed 0, and keeps its
blocks); every rank reads rank 0's batches and takes the placed step
(``train/step.py``: partitioned over the model axis for the dense and
MoE families, data-parallel for the others).  On one card: a 1 x 1
mesh, one card's numbers.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.api.scenario import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.types import SLA, SLAPolicy
from repro_torch.data import SyntheticSource, batches
from repro_torch.distributed.sharding import mesh_shape, set_mesh
from repro_torch.launch.mesh import (close_world, init_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state
from repro_torch.train.trainer import TrainerConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (dev boxes)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel degree of the host mesh")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 pod mesh (needs 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--sla", default="max_tput",
                    choices=["max_tput", "min_energy"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = init_world(dev)
    try:
        return _train(args, dev)
    finally:
        if started:
            close_world()


def _train(args, dev):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build(cfg)
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=dev)
    else:
        mesh = make_host_mesh(model=args.tp, device=dev)
    print(f"mesh: {mesh_shape(mesh)} ({dev})  arch: {cfg.name} "
          f"({cfg.param_count() / 1e6:.1f}M params)")

    with set_mesh(mesh):
        state = init_train_state(bundle, 0, device=dev, mesh=mesh)

        sla = SLA(policy=SLAPolicy.MAX_THROUGHPUT if args.sla == "max_tput"
                  else SLAPolicy.MIN_ENERGY, timeout_s=0.5, max_ch=8)
        data = batches(SyntheticSource(cfg.vocab_size, 1 << 16),
                       batch=args.batch, seq=args.seq, tuned=True, sla=sla)
        opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                             ckpt_every=50, log_every=10,
                             microbatches=args.microbatches)
        try:
            _, report = train(bundle, opt_cfg, rank0_batches(data, dev),
                              tcfg, device=dev, state=state)
        finally:
            data.close()                  # stops the tuned fetcher
    print(f"final loss {report.final_loss:.4f} over {report.steps_run} "
          f"steps; stragglers={report.straggler_steps}")
    return report


def rank0_batches(data, dev):
    """``data``'s batches with every rank's replaced by rank 0's (a
    broadcast over the world; the batches themselves at one rank): the
    ranks' tuned fetchers deliver shards in their own orders."""
    for batch in data:
        if dist.get_world_size() > 1:
            batch = {k: v.to(dev) for k, v in batch.items()}
            for v in batch.values():
                dist.broadcast(v, src=0)
        yield batch


if __name__ == "__main__":
    main()
