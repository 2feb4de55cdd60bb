"""Regenerate ``lm_qwen3_0_6b.json``: full-width qwen3-0.6b (28 layers,
d_model 1024, vocab 151,936) in float32 as the JAX package computes it on
the CPU, with weights from ``repro_torch.convert.random_lm_params(seed=0)``
(numpy alone, so the machine with the card draws the same weights).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens/make_lm_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens/make_lm_golden.py \\
        qwen3-moe-30b-a3b qwen2-vl-2b whisper-small

With architecture names, it makes the MoE, VLM and audio goldens
(:data:`FAMILIES`), each in a process of its own, as
``make_recurrent_goldens.py`` makes its two: full width in float32, the
same prompts, steps and records, and a header with the config, the depth
cut, the peak host memory and the seconds of the run.
  * ``lm_qwen3_moe_30b_a3b.json``: 2 of 48 layers (6.23 GB of float32
    weights; full depth is 121 GB), ``moe_impl="gmm"``; each step also
    keeps, per layer, every token's expert set (sorted) and router margin
    (the top_k-th minus the next probability) and their smallest, so that
    a flipped expert set on the card can be told from a fault.
  * ``lm_qwen2_vl_2b.json``: full depth; the prompt's first 16 slots are a
    4 x 4 image grid: ``vision_embeds`` from numpy seed 2 and Qwen2-VL's
    M-RoPE positions (t = 0, h = row, w = col; the text at t = h = w =
    4 + i); decode steps pass positions only, as JAX's decode does.
  * ``lm_whisper_small.json``: full depth; 1,500 frames of
    ``frame_embeds`` from numpy seed 2, encoded once (``whisper.encode``),
    the encoder output passed to the prefill and to every decode step
    through ``whisper.forward`` (JAX's ``make_decode_step`` passes none);
    the records cover the 51,865 real logits, not the padding's -1e30.

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
import resource
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build
from repro.models import layers as JL
from repro.models import whisper as JW
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


#: The MoE, VLM and audio goldens: file, depth cut (None: full depth) and
#: its reason, and weights by position.
FAMILIES = {
    "qwen3-moe-30b-a3b": dict(
        file="lm_qwen3_moe_30b_a3b.json", num_layers=2,
        cut="2 of 48 layers: full depth is 121 GB of float32 weights on "
            "each machine's host",
        check=(("embed", (0, slice(0, 4))),
               ("blocks/moe/router", (1, -1, slice(-4, None))),
               ("blocks/moe/wg", (1, 127, 5, slice(0, 4))),
               ("blocks/moe/wd", (0, 64, -1, slice(-4, None))))),
    "qwen2-vl-2b": dict(
        file="lm_qwen2_vl_2b.json", num_layers=None, cut=None,
        check=(("embed", (0, slice(0, 4))),
               ("blocks/attn/wq", (27, -1, slice(-4, None))),
               ("blocks/mlp/wd", (13, 5, slice(0, 4))))),
    "whisper-small": dict(
        file="lm_whisper_small.json", num_layers=None, cut=None,
        check=(("embed", (-1, slice(0, 4))),
               ("enc_layers/11/attn/wq", (-1, slice(-4, None))),
               ("dec_layers/11/cross_attn/wk", (5, slice(0, 4))),
               ("dec_layers/0/mlp/wd", (13, slice(0, 4))))),
}
EXTRA_SEED = 2
IMAGE_GRID = 4


def leaf_at(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def mrope_positions(batch, T, side):
    """[3, B, T]: a side x side patch grid (t = 0, h = row, w = col), then
    the text at t = h = w = side + i."""
    r, c = np.divmod(np.arange(side * side), side)
    text = side + np.arange(T - side * side)
    pos = np.stack([np.concatenate([np.zeros(side * side, int), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.broadcast_to(pos[:, None], (3, batch, T)).astype(np.int32)


def family_extra(cfg):
    """The family's extra inputs (numpy, float32), from numpy seed 2."""
    rng = np.random.default_rng(EXTRA_SEED)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal(
                    (BATCH, IMAGE_GRID ** 2, cfg.d_model), np.float32),
                "mrope_pos": mrope_positions(BATCH, PROMPT_LEN, IMAGE_GRID)}
    if cfg.family == "audio":
        return {"frame_embeds": rng.standard_normal(
            (BATCH, cfg.encoder_positions, cfg.d_model), np.float32)}
    return {}


def to_jax(tree):
    """numpy leaves -> jnp, one leaf at a time, dropping each numpy array
    once copied (the peak stays near one model)."""
    if isinstance(tree, dict):
        return {k: to_jax(tree.pop(k)) for k in list(tree)}
    if isinstance(tree, list):
        return [to_jax(tree.pop(0)) for _ in range(len(tree))]
    return jnp.asarray(tree)


def family_config(arch, get=t_get_config):
    spec = FAMILIES[arch]
    cfg = dataclasses.replace(get(arch), dtype="float32")
    if spec["num_layers"] is not None:
        cfg = dataclasses.replace(cfg, num_layers=spec["num_layers"])
    return cfg


def make(arch):
    spec = FAMILIES[arch]
    t0 = time.perf_counter()
    cfg = family_config(arch, get_config)
    tree = convert.random_lm_params(family_config(arch), seed=SEED)
    check = {p: [float(x) for x in leaf_at(tree, p)[idx]]
             for p, idx in spec["check"]}
    n_params = sum(int(np.asarray(x).size) for x in jax.tree.leaves(tree))
    params = to_jax(tree)
    bundle = build(cfg)
    prompt = prompts(cfg.vocab_size)
    extra = {k: jnp.asarray(v) for k, v in family_extra(cfg).items()}

    routed = []     # the MoE router's calls: (sorted expert sets, margins)
    if cfg.moe is not None:
        router = JL.moe_router

        def keep(ids, margin):
            routed.append((np.sort(np.asarray(ids), 1).tolist(),
                           np.asarray(margin).tolist()))

        def recorded(c, p, xf):
            w, ids, aux = router(c, p, xf)
            probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], -1)
            top = jax.lax.top_k(probs, c.moe.top_k + 1)[0]
            jax.debug.callback(keep, ids, top[:, -2] - top[:, -1],
                               ordered=True)
            return w, ids, aux
        JL.moe_router = recorded

    state = bundle.init_decode_state(BATCH, PROMPT_LEN + NEW_TOKENS)
    prefill = jax.jit(make_prefill(bundle))
    if cfg.family == "audio":
        # JAX's make_decode_step passes no enc_out: whisper's forward
        # takes it here, encoded once
        enc_out = jax.jit(lambda p, f: JW.encode(cfg, p, f))(
            params, extra.pop("frame_embeds"))
        extra = {"enc_out": enc_out}

        def decode(params, state, tok, pos):
            logits, new_state, _ = bundle.forward(
                params, tok, positions=pos, caches=state, enc_out=enc_out)
            return None, logits, new_state
        step = jax.jit(decode)
    else:
        step = jax.jit(make_decode_step(bundle))
    V = cfg.vocab_size      # whisper's padding logits (-1e30) are left out
    logits, state = prefill(params, state, jnp.asarray(prompt), **extra)
    steps = [step_record(np.asarray(logits[:, -1, :V], np.float32))]
    tok = jnp.asarray([steps[-1]["token"]], jnp.int32).T
    for i in range(NEW_TOKENS - 1):
        pos = jnp.full((BATCH, 1), PROMPT_LEN + i, jnp.int32)
        _, logits, state = step(params, state, tok, pos)
        steps.append(step_record(np.asarray(logits[:, -1, :V], np.float32)))
        tok = jnp.asarray([steps[-1]["token"]], jnp.int32).T
    jax.effects_barrier()
    if cfg.moe is not None:
        L = cfg.num_layers
        assert len(routed) == L * NEW_TOKENS, len(routed)
        for k, s in enumerate(steps):
            calls = routed[k * L:(k + 1) * L]
            s["experts"] = [ids for ids, _ in calls]
            s["router_margins"] = [m for _, m in calls]
            s["router_margin"] = [min(m) for _, m in calls]
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    source = ("repro.serve make_prefill/make_decode_step (jitted), JAX "
              "package on the CPU, float32 model, bf16 caches")
    if cfg.family == "audio":
        source = ("repro.serve make_prefill (jitted) with enc_out from "
                  "whisper.encode, then whisper.forward with enc_out and "
                  "the caches a step (jitted), JAX package on the CPU, "
                  "float32 model, bf16 caches")
    out = {"source": source, "arch": arch, "dtype": "float32",
           "config": dataclasses.asdict(cfg), "depth_cut": spec["cut"],
           "parameters": n_params, "seed": SEED, "prompt_seed": PROMPT_SEED,
           "extra_seed": EXTRA_SEED, "peak_host_gb": round(peak_gb, 2),
           "seconds": round(time.perf_counter() - t0, 1),
           "prompt": prompt.tolist(), "batch": BATCH,
           "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
           "weight_check": check,
           "tokens": np.array([s["token"] for s in steps]).T.tolist(),
           "steps": steps}
    if cfg.family == "vlm":
        out["image_grid"] = IMAGE_GRID
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        spec["file"])
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    top2 = min(m for s in steps for m in s["margin"])
    margin = (f"; smallest router margin "
              f"{min(min(m) for _, m in routed):.6g}" if routed else "")
    print(f"wrote {path}: tokens {out['tokens']}; smallest top-2 margin "
          f"{top2:.6g}{margin}; peak host memory {peak_gb:.2f} GB; "
          f"{out['seconds']} s")


if __name__ == "__main__":
    if len(sys.argv) == 1:
        main()
    elif len(sys.argv) == 2:
        make(sys.argv[1])
    else:
        for arch in sys.argv[1:]:
            subprocess.run([sys.executable, __file__, arch], check=True)
