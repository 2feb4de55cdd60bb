"""Regenerate ``train_qwen3_0_6b.json``: two training steps of full-width,
full-depth qwen3-0.6b (28 layers, d_model 1024, vocab 151,936) in float32
as the JAX package computes them on the CPU, from the weights of
``repro_torch.convert.random_lm_params(seed=0)`` (numpy alone, so the
machine with the card draws the same weights).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_goldens/make_train_golden.py

Tokens are B = 2 rows of T + 1 = 129 from ``np.random.default_rng(3)``,
split into tokens and labels shifted by one, as ``repro.data.batches``
does.  The step is ``repro.train.make_train_step`` (jitted, remat on) with
``AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)``.  The file keeps
loss, ce, grad_norm and lr of both steps, the step-1 gradient's L2 norm
per leaf and a few slices of it (``CHECK_LEAVES``), and the same slices of
the parameters after step 2.  The port reproduces it on the card
(chip_smoke.py phase 11).  Peak host memory is about 12 GB.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build
from repro.optim import AdamWConfig, adamw_init
from repro.train import TrainState, make_loss_fn, make_train_step
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config

ARCH = "qwen3-0.6b"
SEED = 0
TOKEN_SEED = 3
BATCH, SEQ = 2, 128
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

#: Leaf slices by position: a stacked leaf at a few layers, the norms, and
#: the embedding rows of the first batch token and of an unused token.
CHECK_LEAVES = (("embed", (None, slice(0, 8))),
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
                ("final_norm/scale", (slice(0, 8),)))


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def batch(vocab):
    arr = np.random.default_rng(TOKEN_SEED).integers(
        0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def index(idx, tokens):
    """CHECK_LEAVES index with ``None`` (the first batch token) resolved."""
    return tuple(int(tokens[0, 0]) if i is None else i for i in idx)


def slices(tree, tokens):
    return [[float(x) for x in np.asarray(leaf(tree, p))[index(idx, tokens)]]
            for p, idx in CHECK_LEAVES]


def main(path=None):
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH), dtype="float32")
    assert cfg.remat and cfg.remat_save == "nothing"
    tree = convert.random_lm_params(tcfg, seed=SEED)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    bundle = build(cfg)
    b = batch(cfg.vocab_size)
    jb = jax.tree.map(jnp.asarray, b)

    # the step-1 gradient, kept only as per-leaf norms and slices
    loss_fn = make_loss_fn(bundle)

    @jax.jit
    def grad_summary(params, batch):
        g = jax.grad(lambda p: loss_fn(p, batch)[0])(params)
        norms = jax.tree.map(lambda x: jnp.sqrt(jnp.sum(jnp.square(x))), g)
        return norms, [leaf(g, p)[index(idx, b["tokens"])]
                       for p, idx in CHECK_LEAVES]
    gnorms, gslices = grad_summary(params, jb)
    grad_norms = {"/".join(str(getattr(k, "key", k)) for k in path):
                  float(v) for path, v in
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
           "arch": ARCH, "dtype": "float32", "seed": SEED,
           "token_seed": TOKEN_SEED, "batch": BATCH, "seq": SEQ,
           "opt": OPT, "steps": steps,
           "check_leaves": [[p, [None if i is None else
                                 ([i.start, i.stop] if isinstance(i, slice)
                                  else i) for i in idx]]
                            for p, idx in CHECK_LEAVES],
           "grad_leaf_norms": grad_norms,
           "grad_slices": [[float(x) for x in np.asarray(s)]
                           for s in gslices],
           "param_slices_after_2": slices(state.params, b["tokens"])}
    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "train_qwen3_0_6b.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}: {steps}")


if __name__ == "__main__":
    main()
