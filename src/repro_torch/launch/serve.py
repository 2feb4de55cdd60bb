"""Serving launcher: batched greedy decoding against a KV cache or a
recurrent state, on the CUDA card unless ``--device cpu`` (the port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --device cpu --smoke --batch 4 --prompt-len 16 --new-tokens 32

Weights are random (``torch.Generator`` seed 0), the prompt is drawn with
numpy seed 1.  The audio family (whisper) attends to encoder output
``enc_out`` [B, 1,500, d_model] drawn in bf16 with numpy seed 2 (JAX's
launcher draws it with key 2), passed to the prefill and to every decode
step; the VLM serves text alone, as JAX's launcher does; the MoE family
runs ``moe_impl="gmm"``.  The kernels (flash attention, WKV, RG-LRU) run
on the card and their plain versions on the CPU; the launcher prints how
many times each kernel launched in the prefill and in one decode step.

It runs under the host mesh of ``--tp`` model ranks (``launch/mesh.py``;
a world of one rank is started when no process group runs, and ended
after), as JAX's does: no parameter is placed by specs when serving, so
every rank computes tp 1's tokens; a ``--tp`` beyond the world raises as
JAX's mesh does without the devices.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.scenario import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.sharding import set_mesh
from repro_torch.kernels.flash_attention import flash_attention_bhtd
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.rwkv6 import wkv_bhtd
from repro_torch.launch.mesh import close_world, init_world, make_host_mesh
from repro_torch.models import build
from repro_torch.serve import make_decode_step, make_prefill


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = init_world(dev)
    try:
        with set_mesh(make_host_mesh(model=args.tp, device=dev)):
            return _serve(args, dev)
    finally:
        if started:
            close_world()


def _serve(args, dev):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build(cfg)
    params = bundle.init_params(0, device=dev)
    B, T, N = args.batch, args.prompt_len, args.new_tokens
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)), device=dev)
    state = bundle.init_decode_state(B, T + N, device=dev)

    prefill = make_prefill(bundle)
    step = make_decode_step(bundle)

    kw = {}
    if cfg.family == "audio":
        enc = np.random.default_rng(2).standard_normal(
            (B, cfg.encoder_positions, cfg.d_model), dtype=np.float32)
        kw["enc_out"] = torch.as_tensor(enc, device=dev).to(torch.bfloat16)

    before = launch_counts()
    logits, state = prefill(params, state, prompt, **kw)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pre = launch_counts(before)
    toks = [tok]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    dec = None
    for i in range(N - 1):
        pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
        before = launch_counts()
        tok, _, state = step(params, state, tok, pos, **kw)
        if i == 0:
            dec = launch_counts(before)
        toks.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    print(f"{cfg.name} on {dev}: {B * (N - 1) / dt:.1f} tok/s batched "
          f"({dt / max(N - 1, 1) * 1e3:.2f} ms/step); kernel launches in "
          f"the prefill {pre}, in one decode step {dec}")
    return torch.cat(toks, dim=1)


#: Every kernel a serving path can launch, by name.
KERNELS = {"flash_attention": flash_attention_bhtd, "wkv": wkv_bhtd,
           "rglru": rglru_scan}


def launch_counts(since=None):
    """Each kernel's launch count, or its launches after ``since``."""
    now = {name: fn.launches for name, fn in KERNELS.items()}
    return now if since is None else {k: now[k] - since[k] for k in now}


if __name__ == "__main__":
    main()
