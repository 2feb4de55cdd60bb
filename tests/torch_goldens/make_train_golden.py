"""Regenerate a training golden: two training steps in float32 as the JAX
package computes them on the CPU, from the weights of
``repro_torch.convert.random_lm_params(seed=0)`` (numpy alone, so the
machine with the card draws the same weights).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens/make_train_golden.py [arch]

``arch`` (default qwen3-0.6b) picks a row of :data:`GOLDENS`:

  * ``qwen3-0.6b`` -> ``train_qwen3_0_6b.json``: full width and depth (28
    layers, d_model 1024, vocab 151,936); B = 2 rows of T + 1 = 129
    tokens.  Peak host memory about 12 GB.
  * ``recurrentgemma-2b`` -> ``train_recurrentgemma_2b.json``: full width
    (d_model 2,560, 10/1 heads of 256, window 2,048, d_ff 7,680, vocab
    256,000), cut to its first 3 of 26 layers (rglru, rglru, local: one of
    each kind of the block pattern); B = 1 row of T + 1 = 2,177 tokens, so
    that T > window and the window mask cuts the attention.  The header
    states the cut; peak host memory is recorded in it.
  * ``rwkv6-7b`` -> ``train_rwkv6_7b.json``: full width (d_model 4,096, 64
    heads of 64, d_ff 14,336, vocab 65,536), cut to 4 of its 32 layers
    (``lm_rwkv6_7b.json``'s cut and seed); B = 1 row of T + 1 = 201
    tokens: three 64-step WKV checkpoints and a ragged tail.  Its slices
    reach every kind of leaf, ``tm/u``, ``tm/w0``, ``tm/w_A``,
    ``tm/mix_A`` and ``tm/gn_scale`` (which only the WKV backward
    reaches) among them.  Peak host memory about 25 GB, ~80 s.

Tokens come from ``np.random.default_rng(3)``, split into tokens and labels
shifted by one, as ``repro.data.batches`` does.  The step is
``repro.train.make_train_step`` (jitted, remat on) with
``AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)``.  The file keeps
loss, ce, grad_norm and lr of both steps, the step-1 gradient's L2 norm
per leaf and a few slices of it (the row's ``check``), and the same slices
of the parameters after step 2.  The port reproduces them on the card
(chip_smoke.py phases 11, 19c and 22b).
"""
import dataclasses
import json
import os
import resource
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build
from repro.optim import AdamWConfig, adamw_init
from repro.train import TrainState, make_loss_fn, make_train_step
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config

SEED = 0
TOKEN_SEED = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

#: Per architecture: the golden's file, the depth cut (None: full depth)
#: and its reason, the batch, and the leaf slices by position kept of the
#: gradient and the weights: the embedding rows of the first batch token
#: and of an unused token, and a few entries of every kind of leaf.
GOLDENS = {
    "qwen3-0.6b": dict(
        file="train_qwen3_0_6b.json", num_layers=None, cut=None, batch=2,
        seq=128,
        check=(("embed", (None, slice(0, 8))),
               ("embed", (151935, slice(0, 8))),
               ("blocks/attn/wq", (27, -1, slice(-8, None))),
               ("blocks/attn/wk", (0, 3, slice(0, 8))),
               ("blocks/attn/wo", (14, 100, slice(0, 8))),
               ("blocks/attn/q_norm", (5, slice(0, 8))),
               ("blocks/attn/k_norm", (27, slice(0, 8))),
               ("blocks/ln1/scale", (0, slice(0, 8))),
               ("blocks/ln2/scale", (20, slice(0, 8))),
               ("blocks/mlp/wd", (13, 5, slice(0, 8))),
               ("blocks/mlp/wg", (27, 7, slice(0, 8))),
               ("final_norm/scale", (slice(0, 8),)))),
    "recurrentgemma-2b": dict(
        file="train_recurrentgemma_2b.json", num_layers=3,
        cut="3 of 26 layers (rglru, rglru, local: the block pattern once): "
            "the full depth's float32 train state is 32 GB on a host, JAX's "
            "update takes a second copy",
        batch=1, seq=2176,
        check=(("embed", (None, slice(0, 8))),
               ("embed", (255999, slice(0, 8))),
               ("layers/0/rec/wx", (5, slice(0, 8))),
               ("layers/0/rec/gate_a/w", (3, 7, slice(0, 8))),
               ("layers/0/rec/gate_x/b", (slice(0, 8),)),
               ("layers/1/rec/lam", (slice(0, 8),)),
               ("layers/1/rec/conv_w", (2, slice(0, 8))),
               ("layers/1/rec/wo", (100, slice(0, 8))),
               ("layers/1/ln1/scale", (slice(0, 8),)),
               ("layers/2/attn/wq", (7, slice(-8, None))),
               ("layers/2/attn/wk", (0, slice(0, 8))),
               ("layers/2/attn/wv", (11, slice(0, 8))),
               ("layers/2/attn/wo", (300, slice(0, 8))),
               ("layers/2/mlp/wd", (13, slice(0, 8))),
               ("final_norm/scale", (slice(0, 8),)))),
    "rwkv6-7b": dict(
        file="train_rwkv6_7b.json", num_layers=4,
        cut="4 of 32 layers (the serving golden's cut and seed): the full "
            "depth's float32 train state is 91 GB on a host",
        batch=1, seq=200,
        check=(("embed", (None, slice(0, 8))),
               ("ln0/scale", (slice(0, 8),)),
               ("blocks/ln1/scale", (0, slice(0, 8))),
               ("blocks/ln2/bias", (1, slice(0, 8))),
               ("blocks/tm/mu", (1, 4, slice(0, 8))),
               ("blocks/tm/mix_A", (3, 2, 100, slice(0, 8))),
               ("blocks/tm/mix_B", (0, 4, 3, slice(0, 8))),
               ("blocks/tm/w0", (0, slice(0, 8))),
               ("blocks/tm/w_A", (1, 5, slice(0, 8))),
               ("blocks/tm/w_B", (2, 7, slice(0, 8))),
               ("blocks/tm/u", (3, slice(0, 8))),
               ("blocks/tm/wr", (3, 7, slice(-8, None))),
               ("blocks/tm/wk", (0, 3, slice(0, 8))),
               ("blocks/tm/wv", (1, 11, slice(0, 8))),
               ("blocks/tm/wg", (2, 100, slice(0, 8))),
               ("blocks/tm/wo", (3, 300, slice(0, 8))),
               ("blocks/tm/gn_scale", (2, slice(0, 8))),
               ("blocks/cm/mu_k", (3, slice(0, 8))),
               ("blocks/cm/wk", (0, 13, slice(0, 8))),
               ("blocks/cm/wv", (1, 5, slice(0, 8))),
               ("blocks/cm/wr", (2, 9, slice(0, 8))),
               ("ln_out/scale", (slice(0, 8),)),
               ("head", (5, slice(0, 8))),
               ("head", (4095, slice(-8, None))))),
}


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def batch(vocab, rows, seq):
    arr = np.random.default_rng(TOKEN_SEED).integers(
        0, vocab, (rows, seq + 1)).astype(np.int32)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def index(idx, tokens):
    """A ``check`` index with ``None`` (the first batch token) resolved."""
    return tuple(int(tokens[0, 0]) if i is None else i for i in idx)


def slices(tree, tokens, check):
    return [[float(x) for x in np.asarray(leaf(tree, p))[index(idx, tokens)]]
            for p, idx in check]


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def main(arch="qwen3-0.6b", path=None):
    row = GOLDENS[arch]
    t0 = time.time()
    cut = {} if row["num_layers"] is None else {
        "num_layers": row["num_layers"]}
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
    tcfg = dataclasses.replace(t_get_config(arch), dtype="float32", **cut)
    assert cfg.remat and cfg.remat_save == "nothing"
    tree = convert.random_lm_params(tcfg, seed=SEED)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    bundle = build(cfg)
    check = row["check"]
    b = batch(cfg.vocab_size, row["batch"], row["seq"])
    jb = jax.tree.map(jnp.asarray, b)

    # the step-1 gradient, kept only as per-leaf norms and slices
    loss_fn = make_loss_fn(bundle)

    @jax.jit
    def grad_summary(params, batch):
        g = jax.grad(lambda p: loss_fn(p, batch)[0])(params)
        norms = jax.tree.map(lambda x: jnp.sqrt(jnp.sum(jnp.square(x))), g)
        return norms, [leaf(g, p)[index(idx, b["tokens"])]
                       for p, idx in check]
    gnorms, gslices = grad_summary(params, jb)
    grad_norms = {_path(p): float(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(gnorms)[0]}

    state = TrainState(params=params, opt=adamw_init(params),
                       step=jnp.zeros((), jnp.int32))
    del params
    step = jax.jit(make_train_step(bundle, AdamWConfig(**OPT)),
                   donate_argnums=(0,))
    steps = []
    for _ in range(2):
        state, m = step(state, jb)
        steps.append({k: float(m[k]) for k in ("loss", "ce", "aux",
                                                "grad_norm", "lr")})
    out = {"source": "repro.train.make_train_step (jitted, remat on), JAX "
                     "package on the CPU, float32 model",
           "arch": arch, "dtype": "float32"}
    if row["cut"] is not None:
        out.update(depth_cut=row["cut"], num_layers=cfg.num_layers,
                   parameters=int(sum(x.size for x in
                                      jax.tree.leaves(state.params))),
                   peak_host_gb=round(resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2),
                   seconds=round(time.time() - t0, 1))
    out.update({"seed": SEED, "token_seed": TOKEN_SEED,
                "batch": row["batch"], "seq": row["seq"], "opt": OPT,
                "steps": steps,
                "check_leaves": [[p, [None if i is None else
                                      ([i.start, i.stop]
                                       if isinstance(i, slice) else i)
                                      for i in idx]] for p, idx in check],
                "grad_leaf_norms": grad_norms,
                "grad_slices": [[float(x) for x in np.asarray(s)]
                                for s in gslices],
                "param_slices_after_2": slices(state.params, b["tokens"],
                                               check)})
    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                row["file"])
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}: {steps}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
