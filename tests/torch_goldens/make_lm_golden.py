"""Regenerate ``lm_qwen3_0_6b.json``: full-width qwen3-0.6b (28 layers,
d_model 1024, vocab 151,936) in float32 as the JAX package computes it on
the CPU, with weights from ``repro_torch.convert.random_lm_params(seed=0)``
(numpy alone, so the machine with the card draws the same weights).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens/make_lm_golden.py

Two prompts of 32 tokens (numpy seed 1) are prefilled into JAX's default
bf16 caches, then 16 greedy tokens are decoded (``repro.serve``'s
``make_prefill`` / ``make_decode_step``, as ``generate`` runs them).  For
every one of the 16 steps the file keeps each row's greedy token, the top-5
logit values and ids, the top-1/top-2 margin and the logits' L2 norm.  The
port reproduces it on the card (chip_smoke.py phase 8).  Peak host memory
is about 6 GB.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build
from repro.serve import make_decode_step, make_prefill
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config

ARCH = "qwen3-0.6b"
SEED = 0
PROMPT_SEED = 1
BATCH, PROMPT_LEN, NEW_TOKENS = 2, 32, 16

#: A few weights by position, to show that both machines drew the same.
CHECK_LEAVES = (("embed", (0, slice(0, 4))),
                ("blocks/attn/wq", (27, -1, slice(-4, None))),
                ("blocks/mlp/wd", (13, 5, slice(0, 4))))


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def weight_check(tree):
    return {p: [float(x) for x in leaf(tree, p)[idx]]
            for p, idx in CHECK_LEAVES}


def prompts(vocab):
    return np.random.default_rng(PROMPT_SEED).integers(
        0, vocab, (BATCH, PROMPT_LEN)).astype(np.int32)


def step_record(logits):
    """[B, V] float32 logits -> what the golden keeps of one step."""
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :5]
    vals = np.take_along_axis(logits, top, axis=-1)
    return {"token": logits.argmax(-1).tolist(),
            "top5_ids": top.tolist(), "top5": vals.tolist(),
            "margin": (vals[:, 0] - vals[:, 1]).tolist(),
            "norm": np.linalg.norm(logits.astype(np.float64),
                                   axis=-1).tolist()}


def main():
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH), dtype="float32")
    tree = convert.random_lm_params(tcfg, seed=SEED)
    check = weight_check(tree)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    bundle = build(cfg)
    prompt = prompts(cfg.vocab_size)
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
    out = {"source": "repro.serve make_prefill/make_decode_step (jitted), "
                     "JAX package on the CPU, float32 model, bf16 caches",
           "arch": ARCH, "dtype": "float32", "seed": SEED,
           "prompt_seed": PROMPT_SEED, "prompt": prompt.tolist(),
           "batch": BATCH, "prompt_len": PROMPT_LEN,
           "new_tokens": NEW_TOKENS, "weight_check": check,
           "tokens": np.array([s["token"] for s in steps]).T.tolist(),
           "steps": steps}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lm_qwen3_0_6b.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    margins = [m for s in steps for m in s["margin"]]
    print(f"wrote {path}: tokens {out['tokens']}; smallest top-2 margin "
          f"{min(margins):.6g}")


if __name__ == "__main__":
    main()
