"""How well float32 can hold rwkv6's training parity: the readings behind
the rwkv6 tolerances of tests/test_torch_train.py (``MU_ATOL``) and of
chip_smoke.py phase 22b (``RWKV_TRAIN_TOL``), on the CPU.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tests/torch_goldens/measure_rwkv6_conditioning.py [part ...]

Parts (default: all, in this order; each ``golden-*`` part takes 15-26 GB
of host memory and 1-3 minutes):

  * ``smoke`` -- rwkv6-smoke and recurrentgemma-smoke at
    tests/test_torch_train.py's cell: the port's three steps against
    three jitted JAX steps, the largest first-Adam-moment difference as a
    share of its leaf's largest |mu|; the weights more than 1e-5 apart
    after step 1 with their step-1 gradients; and each step's gradient at
    equal weights (JAX's state before the step), port against JAX.
  * ``golden-jit`` -- make_train_golden.py's rwkv6-7b cell: JAX's step-1
    gradient op by op (``jax.disable_jit``) against the golden (jitted).
  * ``golden-f64`` -- the same cell's step-1 gradient in float64 (the
    port's model on the CPU, its float32 casts lifted), against the golden
    and against the port in float32.
  * ``golden-ulp`` -- the golden's two jitted steps with every weight moved
    by about one float32 ulp (x (1 +- 2^-24), numpy seed 1), against the
    golden's metrics.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import make_train_golden as mtg  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import AdamWConfig, adamw_init  # noqa: E402
from repro.train import TrainState  # noqa: E402
from repro.train import make_loss_fn as j_make_loss_fn  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.train import loss_and_grads, make_loss_fn  # noqa: E402

GOLDEN = os.path.join(HERE, "train_rwkv6_7b.json")


def _gold():
    with open(GOLDEN) as f:
        return json.load(f)


def _golden_cfgs():
    gold = _gold()
    cut = dict(dtype="float32", num_layers=gold["num_layers"])
    return (gold, dataclasses.replace(get_config(gold["arch"]), **cut),
            dataclasses.replace(t_get_config(gold["arch"]), **cut))


def _norm_errs(grads, gold):
    """{leaf: |norm - golden norm| / golden norm} over the golden's leaves."""
    return {p: abs(float(np.linalg.norm(np.asarray(
        mtg.leaf(grads, p), np.float64))) - w) / w
        for p, w in gold["grad_leaf_norms"].items()}


def _worst(errs, n=4):
    return [(p, f"{e:.3g}") for p, e in sorted(errs.items(),
                                                key=lambda x: x[1])[-n:]]


def smoke():
    import test_torch_train as T

    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg, tcfg = T._cfgs(arch)
        js, ts, _, grads1 = T._run_both(cfg, tcfg, 3)
        mu = max(float(np.abs(a - b).max() / np.abs(a).max())
                 for _, a, b in T._leaf_pairs(js.opt.mu, ts.opt.mu))
        js1, ts1, _, _ = T._run_both(cfg, tcfg, 1)
        g1 = {p: g for p, g, _ in T._leaf_pairs(grads1, ts1.params)}
        apart = [(p, tuple(int(i) for i in idx),
                  f"{float(g1[p][tuple(idx)]):.3g}")
                 for p, a, b in T._leaf_pairs(js1.params, ts1.params)
                 for idx in np.argwhere(np.abs(a - b) > 1e-5)]
        # each step's gradient at equal weights: JAX's state before it
        js, _ = T._states(cfg, tcfg)
        jstep = jax.jit(j_make_train_step(jbuild(cfg), AdamWConfig(**T.OPT)))
        grad = jax.jit(jax.grad(lambda p, b: j_make_loss_fn(jbuild(cfg))(
            p, b)[0]))
        worst = 0.0
        for b in T._batches(cfg.vocab_size, 3):
            jg = grad(js.params, T._jnp(b))
            params = convert.lm_params_from_jax(jax.device_get(js.params),
                                                tcfg, "cpu")
            flat = [(p, x.requires_grad_()) for p, x in T._flat(params)]
            tl, _ = make_loss_fn(tbuild(tcfg))(params, b)
            grads = torch.autograd.grad(tl, [x for _, x in flat])
            tg = T._unflat([(p, g) for (p, _), g in zip(flat, grads)])
            worst = max(worst, max(
                float(np.abs(a - g).max() / np.abs(a).max())
                for _, a, g in T._leaf_pairs(jg, tg)))
            js, _ = jstep(js, T._jnp(b))
        print(f"[smoke] {arch}: first Adam moment after 3 steps, max |port - "
              f"JAX| / leaf max {mu:.3g}; weights > 1e-5 apart after step 1 "
              f"(leaf, index, JAX's step-1 gradient) {apart}; each step's "
              f"gradient at equal weights, max |port - JAX| / leaf max "
              f"{worst:.3g}", flush=True)


def golden_jit():
    gold, cfg, tcfg = _golden_cfgs()
    params = jax.tree.map(jnp.asarray, convert.random_lm_params(
        tcfg, seed=gold["seed"]))
    b = mtg.batch(cfg.vocab_size, gold["batch"], gold["seq"])
    with jax.disable_jit():
        g = jax.grad(lambda p: j_make_loss_fn(jbuild(cfg))(
            p, jax.tree.map(jnp.asarray, b))[0])(params)
    slices = max(
        float(np.abs(np.asarray(mtg.leaf(g, p), np.float64)[mtg.index(
            tuple(None if i is None else slice(*i) if isinstance(i, list)
                  else i for i in idx), b["tokens"])] - np.asarray(w)).max()
              / np.abs(np.asarray(w)).max())
        for (p, idx), w in zip(gold["check_leaves"], gold["grad_slices"]))
    print(f"[golden-jit] JAX op by op vs the golden (jitted): leaf norms "
          f"{_worst(_norm_errs(g, gold))}; slices max {slices:.3g} of each "
          f"slice's max", flush=True)


def golden_f64():
    gold, cfg, tcfg = _golden_cfgs()
    tree = convert.random_lm_params(tcfg, seed=gold["seed"])
    b = mtg.batch(cfg.vocab_size, gold["batch"], gold["seq"])
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    params = convert.lm_params_from_jax(tree, tcfg, "cpu")
    del tree
    bundle = tbuild(tcfg)
    paths = list(gold["grad_leaf_norms"])
    _, _, _, g32 = loss_and_grads(make_loss_fn(bundle), params, tb)
    n32 = {p: float(mtg.leaf(g32, p).double().norm()) for p in paths}
    del g32

    def to64(t):
        return ({k: to64(v) for k, v in t.items()} if isinstance(t, dict)
                else t.double().requires_grad_())

    params = to64(params)
    to_float = torch.Tensor.float
    # the model's float32 casts (norms, the decay) keep float64 here
    torch.Tensor.float = lambda x, *a, **k: (
        x if x.dtype == torch.float64 else to_float(x, *a, **k))
    try:   # the backward recomputes each block (remat): keep the patch
        logits = bundle.forward(params, tb["tokens"].long())[0]
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            tb["labels"].long().reshape(-1))
        grads = torch.autograd.grad(loss, [mtg.leaf(params, p)
                                           for p in paths])
    finally:
        torch.Tensor.float = to_float
    n64 = {p: float(g.norm()) for p, g in zip(paths, grads)}
    want = gold["grad_leaf_norms"]
    gold_off = {p: abs(want[p] - n64[p]) / n64[p] for p in paths}
    port_off = {p: abs(n32[p] - n64[p]) / n64[p] for p in paths}
    port_gold = {p: abs(n32[p] - want[p]) / want[p] for p in paths}
    print(f"[golden-f64] leaf norms against float64 (loss "
          f"{float(loss.detach()):.9g}, golden "
          f"{gold['steps'][0]['loss']:.9g}): the golden, every leaf "
          f"{_worst(gold_off, len(paths))}; the port in float32 "
          f"{_worst(port_off, 6)}"
          f"; the port in float32 against the golden {_worst(port_gold)}",
          flush=True)


def golden_ulp():
    gold, cfg, tcfg = _golden_cfgs()
    rng = np.random.default_rng(1)

    def nudge(x):
        s = rng.integers(0, 2, x.shape).astype(np.float32) * 2 - 1
        return jnp.asarray(x * (np.float32(1) + s * np.float32(2.0 ** -24)))

    params = jax.tree.map(nudge, convert.random_lm_params(
        tcfg, seed=gold["seed"]))
    b = jax.tree.map(jnp.asarray, mtg.batch(cfg.vocab_size, gold["batch"],
                                            gold["seq"]))
    state = TrainState(params=params, opt=adamw_init(params),
                       step=jnp.zeros((), jnp.int32))
    del params
    step = jax.jit(j_make_train_step(jbuild(cfg), AdamWConfig(**gold["opt"])),
                   donate_argnums=(0,))
    for i, want in enumerate(gold["steps"]):
        state, m = step(state, b)
        print(f"[golden-ulp] step {i + 1}: " + ", ".join(
            f"{k} {float(m[k]):.9g} vs {want[k]:.9g} (rel "
            f"{abs(float(m[k]) - want[k]) / abs(want[k]):.3g})"
            for k in ("loss", "grad_norm")), flush=True)


PARTS = {"smoke": smoke, "golden-jit": golden_jit, "golden-f64": golden_f64,
         "golden-ulp": golden_ulp}

if __name__ == "__main__":
    for part in sys.argv[1:] or PARTS:
        PARTS[part]()
