"""Training launcher on one card, or on the CPU with ``--device cpu`` (the
port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 32

The flow is JAX's: train state -> SLA-tuned ingest -> fault-tolerant
trainer.  The single-card mesh is the card itself; ``--tp`` > 1 and the
production / multi-pod meshes belong to the multi-card slice (ROADMAP
queue 1, item 9e).  Weights are random, drawn on the device by a
``torch.Generator`` there with seed 0.
"""
from __future__ import annotations

import argparse

from repro_torch.api.scenario import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.types import SLA, SLAPolicy
from repro_torch.data import SyntheticSource, batches
from repro_torch.models import build
from repro_torch.optim import AdamWConfig
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
                    help="model-parallel degree (1: one card)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--sla", default="max_tput",
                    choices=["max_tput", "min_energy"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tp != 1 or args.production_mesh or args.multi_pod:
        raise NotImplementedError("multi-card training (--tp > 1, "
                                  "--production-mesh, --multi-pod) is "
                                  "queued: ROADMAP queue 1, item 9e")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build(cfg)
    print(f"mesh: {{'data': 1, 'model': 1}} ({dev})  arch: {cfg.name} "
          f"({cfg.param_count() / 1e6:.1f}M params)")

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
        _, report = train(bundle, opt_cfg, data, tcfg, device=dev)
    finally:
        data.close()                  # stops the tuned fetcher
    print(f"final loss {report.final_loss:.4f} over {report.steps_run} "
          f"steps; stragglers={report.straggler_steps}")
    return report


if __name__ == "__main__":
    main()
