"""Regenerate ``lm_rwkv6_7b.json`` and ``lm_recurrentgemma_2b.json``: the two
recurrent families at full width in float32, as the JAX package computes
them on the CPU, with weights from ``repro_torch.convert.random_lm_params
(seed=0)`` (numpy alone, so the machine with the card draws the same
weights).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens/make_recurrent_goldens.py [arch ...]

Each architecture runs in a process of its own (with no argument, both, one
after the other), so the host holds one model at a time:

  * rwkv6-7b (32 layers, d_model 4096, 64 heads of 64, d_ff 14,336, vocab
    65,536) is cut to its first 4 layers: the full depth is 7.57 B
    parameters, 30.3 GB in float32, on each machine's host and in JAX's
    copy of it.  Width, vocabulary and every other field are the config's.
    About 1.4 B parameters, 5.7 GB.
  * recurrentgemma-2b runs at full width and depth (26 layers, 18 RG-LRU and
    8 local-MQA; 2.69 B parameters, 10.8 GB).

Two prompts of 32 tokens (numpy seed 1) are prefilled into JAX's default
decode state (bf16 token-shift carries, ring caches and conv states; float32
recurrences), then 16 greedy tokens are decoded (``repro.serve``'s
``make_prefill`` / ``make_decode_step``, jitted, as ``generate`` runs them).
For every step the file keeps each row's greedy token, the top-5 logit
values and ids, the top-1/top-2 margin and the logits' L2 norm, as
``make_lm_golden.py`` does; the header names the config, the depth cut, the
seeds and the peak host memory of the run.  The port reproduces both on the
card (chip_smoke.py phase 15).
"""
import dataclasses
import json
import os
import resource
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build
from repro.serve import make_decode_step, make_prefill
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config

from make_lm_golden import step_record

SEED = 0
PROMPT_SEED = 1
BATCH, PROMPT_LEN, NEW_TOKENS = 2, 32, 16

#: Per architecture: the golden's file, the depth cut (None: full depth)
#: and its reason, and a few weights by position, to show that both
#: machines drew the same.
GOLDENS = {
    "rwkv6-7b": dict(
        file="lm_rwkv6_7b.json", num_layers=4,
        cut="4 of 32 layers: full depth is 30.3 GB of float32 weights on "
            "each machine's host",
        check=(("embed", (0, slice(0, 4))),
               ("blocks/tm/wr", (3, -1, slice(-4, None))),
               ("blocks/cm/wv", (1, 5, slice(0, 4))),
               ("head", (-1, slice(-4, None))))),
    "recurrentgemma-2b": dict(
        file="lm_recurrentgemma_2b.json", num_layers=None, cut=None,
        check=(("embed", (0, slice(0, 4))),
               ("layers/0/rec/wx", (-1, slice(-4, None))),
               ("layers/2/attn/wq", (5, slice(0, 4))),
               ("layers/25/mlp/wd", (13, slice(0, 4))))),
}


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def weight_check(tree, checks):
    return {p: [float(x) for x in leaf(tree, p)[idx]] for p, idx in checks}


def golden_config(arch, get=t_get_config):
    """The golden's config: float32, and the depth cut if there is one."""
    spec = GOLDENS[arch]
    cfg = dataclasses.replace(get(arch), dtype="float32")
    if spec["num_layers"] is not None:
        cfg = dataclasses.replace(cfg, num_layers=spec["num_layers"])
    return cfg


def to_jax(tree):
    """numpy leaves -> jnp, one leaf at a time, dropping each numpy array
    once copied (the peak stays near one model)."""
    if isinstance(tree, dict):
        return {k: to_jax(tree.pop(k)) for k in list(tree)}
    if isinstance(tree, list):
        return [to_jax(tree.pop(0)) for _ in range(len(tree))]
    return jnp.asarray(tree)


def make(arch):
    spec = GOLDENS[arch]
    t0 = time.perf_counter()
    cfg = golden_config(arch, get_config)
    tree = convert.random_lm_params(golden_config(arch), seed=SEED)
    check = weight_check(tree, spec["check"])
    n_params = sum(int(np.asarray(x).size) for x in jax.tree.leaves(tree))
    params = to_jax(tree)
    bundle = build(cfg)
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    state = bundle.init_decode_state(BATCH, PROMPT_LEN + NEW_TOKENS)
    prefill = jax.jit(make_prefill(bundle))
    step = jax.jit(make_decode_step(bundle))
    logits, state = prefill(params, state, jnp.asarray(prompt))
    steps = [step_record(np.asarray(logits[:, -1], np.float32))]
    tok = jnp.asarray([steps[-1]["token"]], jnp.int32).T
    for i in range(NEW_TOKENS - 1):
        pos = jnp.full((BATCH, 1), PROMPT_LEN + i, jnp.int32)
        _, logits, state = step(params, state, tok, pos)
        steps.append(step_record(np.asarray(logits[:, -1], np.float32)))
        tok = jnp.asarray([steps[-1]["token"]], jnp.int32).T
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    out = {"source": "repro.serve make_prefill/make_decode_step (jitted), "
                     "JAX package on the CPU, float32 model, JAX's default "
                     "decode state (bf16 carries and caches)",
           "arch": arch, "dtype": "float32", "config": dataclasses.asdict(cfg),
           "depth_cut": spec["cut"], "parameters": n_params, "seed": SEED,
           "prompt_seed": PROMPT_SEED, "peak_host_gb": round(peak_gb, 2),
           "seconds": round(time.perf_counter() - t0, 1),
           "prompt": prompt.tolist(), "batch": BATCH,
           "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
           "weight_check": check,
           "tokens": np.array([s["token"] for s in steps]).T.tolist(),
           "steps": steps}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        spec["file"])
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    margins = [m for s in steps for m in s["margin"]]
    print(f"wrote {path}: tokens {out['tokens']}; smallest top-2 margin "
          f"{min(margins):.6g}; peak host memory {peak_gb:.2f} GB")


if __name__ == "__main__":
    if len(sys.argv) == 2:
        make(sys.argv[1])
    else:
        for arch in sys.argv[1:] or list(GOLDENS):
            subprocess.run([sys.executable, __file__, arch], check=True)
