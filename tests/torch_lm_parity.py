"""Shared helpers of the LM families' parity tests (tests/test_torch_moe.py,
test_torch_vlm.py, test_torch_whisper.py): weights carried from JAX's init
to the port, tolerance checks, routing records of both packages' MoE
routers, and one train step of each package from the same state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.optim import AdamWConfig as JAdamW
from repro.train import init_train_state as j_init
from repro.train import make_loss_fn as j_make_loss_fn
from repro.train import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import build as tbuild
from repro_torch.models import layers as TL
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step

#: Tolerances, max |logit difference| (test_torch_lm.py's): a float32 model
#: with float32 caches rtol/atol 1e-5; with bf16 caches rtol 1e-4, atol
#: 2e-4; a bf16 model 3% of the largest |logit| (JAX rounds attention
#: scores and probabilities to bf16, the port keeps them in float32).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
F32_BF16_CACHE_TOL = dict(rtol=1e-4, atol=2e-4)
BF16_SHARE = 0.03

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def setup(arch, dtype, **over):
    """(jax cfg, port cfg, jax params, port params): JAX's init, biases and
    norm scales perturbed by numpy so that every parameter matters."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=dtype, **over)
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init_params(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)

    def perturb(node, path=()):
        if isinstance(node, dict):
            return {k: perturb(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v, path) for v in node]
        if path[-1] in ("bq", "bk", "bv", "bu", "bd", "scale", "bias",
                        "q_norm", "k_norm"):
            base = node.astype(np.float32)
            return (base + 0.1 * rng.standard_normal(base.shape, np.float32)
                    ).astype(node.dtype)
        return node
    tree = perturb(tree)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_jax(tree, tcfg, "cpu"))


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def check_f32(t, j, tol=F32_TOL):
    a, b = as_np(t), as_np(j)
    np.testing.assert_allclose(a, b, **tol)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def check_bf16(t, j, rows=None):
    """3% of the largest |logit|, over ``rows`` (a bool mask over the
    leading dims; default all)."""
    a, b = as_np(t), as_np(j)
    if rows is not None:
        a, b = a[rows], b[rows]
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=BF16_SHARE * float(np.abs(b).max()))


class Routing:
    """Records each MoE router call of both packages: the sorted expert
    sets and the router probabilities.  JAX's come out of its traced
    forward through ``jax.debug.callback`` (ordered): trace a fresh
    function after this is made."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        j_router, t_router = JL.moe_router, TL.moe_router

        def keep(ids, probs):
            self.jax.append((np.sort(np.asarray(ids), 1),
                             np.asarray(probs)))

        def j_rec(cfg, p, xf):
            w, ids, aux = j_router(cfg, p, xf)
            probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], -1)
            jax.debug.callback(keep, ids, probs, ordered=True)
            return w, ids, aux

        def t_rec(cfg, p, xf):
            w, ids, aux = t_router(cfg, p, xf)
            probs = torch.softmax(xf.float() @ p["router"], -1)
            self.port.append((ids.sort(1).values.numpy(),
                              probs.detach().numpy()))
            return w, ids, aux
        monkeypatch.setattr(JL, "moe_router", j_rec)
        monkeypatch.setattr(TL, "moe_router", t_rec)

    def flips(self, k, B, spans):
        """Hold every routing difference to a near tie and return, per row,
        the first position from which its logits may differ (None if
        none).

        A token's expert set can differ only where JAX's k-th and (k+1)-th
        probabilities are closer than the two packages' probabilities
        differ: |p_k - p_k+1| <= 2 max |dp| over that token's experts.
        ``spans[i]`` is the i-th call's (first position, length): calls
        come layer by layer, forward by forward."""
        first = [None] * B
        assert len(self.jax) == len(self.port) == len(spans)
        for (jids, jp), (tids, tp), (start, T) in zip(self.jax, self.port,
                                                     spans):
            top = -np.sort(-jp, axis=1)
            margin = top[:, k - 1] - top[:, k]
            dp = np.abs(jp - tp).max(1)
            for n in np.nonzero((jids != tids).any(1))[0]:
                assert margin[n] <= 2 * dp[n], (margin[n], dp[n])
                b, t = divmod(int(n), T)
                pos = start + t
                first[b] = pos if first[b] is None else min(first[b], pos)
        return first

    def clear(self):
        self.jax.clear()
        self.port.clear()


def jit_forward(fn):
    """``fn(cfg, params, tokens, **kw)`` jitted with the config static."""
    return jax.jit(fn, static_argnums=0, static_argnames=("moe_impl",))


def run_train_steps(arch, dtype="float32", batch_kw=None, n_steps=1,
                    microbatches=1, **over):
    """``n_steps`` jitted JAX train steps and the port's from the same
    converted state on the same batches (4 x 32 tokens, numpy seeds;
    ``batch_kw(cfg)`` adds the family's inputs; both steps in
    ``microbatches``) -> (JAX state, port state, [(JAX metrics, port
    metrics)], JAX's step-1 gradients)."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=dtype, **over)
    js = j_init(jbuild(jcfg), jax.random.PRNGKey(0))
    ts = convert.train_state_from_jax(jax.device_get(js), tcfg, "cpu")
    jstep = jax.jit(j_make_train_step(jbuild(jcfg), JAdamW(**OPT),
                                      microbatches=microbatches))
    tstep = make_train_step(tbuild(tcfg), AdamWConfig(**OPT),
                            microbatches=microbatches)
    metrics, grads1 = [], None
    for i in range(n_steps):
        toks = tokens(jcfg, (4, 33), seed=20 + i)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        b.update((batch_kw or (lambda cfg: {}))(jcfg))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if grads1 is None:
            grads1 = jax.jit(jax.grad(lambda p, b: j_make_loss_fn(
                jbuild(jcfg))(p, b)[0]))(js.params, jb)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, {k: torch.from_numpy(np.asarray(v))
                            for k, v in b.items()})
        metrics.append((jm, tm))
    return js, ts, metrics, grads1


def leaf_pairs(jtree, ttree):
    """[(path, JAX leaf, port leaf)] as float32 numpy, over JAX's leaves."""
    out = []
    for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        b = ttree
        for k in path:
            b = b[k.idx if hasattr(k, "idx") else k.key]
        out.append((jax.tree_util.keystr(path), np.asarray(a, np.float32),
                    b.detach().float().numpy()))
    return out


def check_train(js, ts, metrics, grads1, n_steps=1):
    """test_torch_train.py's float32 tolerances: loss and ce rtol 2e-6,
    aux 1e-5, grad norm 1e-5, lr 1e-6; weights within 5e-5 where |g| at
    step 1 exceeds 1e-3 x the leaf's largest (Adam's first step is
    sign-like: a weight whose gradient is near 0 may move either way),
    within 2 lr x steps everywhere."""
    for jm, tm in metrics:
        for k, rtol in (("loss", 2e-6), ("ce", 2e-6), ("aux", 1e-5),
                        ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, atol=1e-12, err_msg=k)
    lr = OPT["lr"]
    for (path, a, b), (_, g, _) in zip(leaf_pairs(js.params, ts.params),
                                       leaf_pairs(grads1, ts.params)):
        d, g = np.abs(a - b), np.abs(g)
        sure = g > 1e-3 * g.max()
        assert (d[sure] <= 5e-5).all(), (path, d[sure].max())
        assert (d <= 2 * lr * n_steps).all(), (path, d.max())
    assert int(ts.step) == int(js.step) == n_steps


def check_random_tree(arch, scales):
    """``random_lm_params`` has JAX's tree (paths, shapes; float32 leaves),
    ``lm_params_from_jax`` gives JAX's dtypes, and each named leaf has its
    init scale (``scales``: path -> expected std, within 5% or four
    standard errors of a sample std, whichever is larger)."""
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: jbuild(cfg).init_params(
        jax.random.PRNGKey(0)))
    tree = convert.random_lm_params(t_smoke(arch), seed=0)
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert tuple(a.shape) == b.shape and b.dtype == np.float32, path
    tp = convert.lm_params_from_jax(tree, t_smoke(arch), "cpu")
    flat_p = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    for (path, a), (_, b) in zip(flat_j, flat_p):
        assert str(b.dtype) == f"torch.{a.dtype}", path
    for path, std in scales.items():
        leaf = tree
        for k in path.split("/"):
            leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
        # the sample std's relative error is ~1/sqrt(2n): 4 of those
        tol = max(0.05, 4.0 / np.sqrt(2 * leaf.size))
        assert abs(leaf.std() / std - 1.0) < tol, (path, leaf.std(), std)
    again = convert.random_lm_params(t_smoke(arch), seed=0)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(tree), jax.tree.leaves(again)))
