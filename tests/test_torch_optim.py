"""The port's AdamW, warmup-cosine schedule and global-norm clipping
against the JAX package's (``repro.optim``), on the same numpy trees.

The port runs JAX's float32 operations in JAX's order, op by op, against
JAX run op by op (``jax.disable_jit()``).  Element-wise results are held to
2 ulp of float32 (bf16 parameters to one bf16 ulp): ``cos`` and ``pow`` are
another library's.  A per-leaf sum of squares runs in another order, so the
global norm -- and, when clipping is active, every clipped gradient and
what follows from it -- is held to rtol 2e-6.  Jitted XLA also skips
the bf16 rounding of a clipped bf16 gradient; the port keeps it, as the
JAX source writes it (ROADMAP queue 3;
:func:`test_jitted_jax_skips_the_bf16_rounding_of_the_clipped_gradient`).
The tree mirrors the LM's: stacked [L, ...] block leaves, whose [L, D]
norm scales are 2-D and so *are* decayed, as in JAX, and a 1-D final norm,
which is not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro_torch.optim import adamw as T

ULPS = 2             # float32 ulps allowed between element-wise results
LR_ULPS = 4          # the schedule: a cos and three more roundings
SUM_RTOL = 2e-6      # a float32 sum in another order (the global norm)


def _tree(rng, dtype):
    def n(*s):
        return rng.standard_normal(s).astype(np.float32)
    t = {"embed": n(40, 16),
         "blocks": {"ln1": {"scale": 1.0 + 0.1 * n(3, 16)},
                    "attn": {"wq": n(3, 16, 24), "q_norm": 1.0 + n(3, 8)}},
         "final_norm": {"scale": 1.0 + 0.1 * n(16)}}
    if dtype == "bfloat16":
        t = {**t, "embed": t["embed"].astype(jnp.bfloat16),
             "blocks": {**t["blocks"], "attn": {
                 **t["blocks"]["attn"],
                 "wq": t["blocks"]["attn"]["wq"].astype(jnp.bfloat16)}}}
    return t


def _torch(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_ulps(got, want, ulps, err_msg=""):
    """|got - want| <= ``ulps`` float32 ulps of the larger magnitude."""
    got, want = np.float32(got), np.float32(want)
    tol = ulps * np.spacing(np.maximum(np.abs(got), np.abs(want)))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (err_msg, got[bad] if got.ndim else got,
                           want[bad] if want.ndim else want)


def _assert_trees(jt, tt, ulps=ULPS, rtol=None):
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    for path, a in jl:
        b = tt
        for k in path:
            b = b[k.key]
        if np.asarray(a).dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(b), _np(a), rtol=2 ** -7,
                                       err_msg=str(path))
        elif rtol is not None:
            np.testing.assert_allclose(_np(b), _np(a), rtol=rtol,
                                       atol=rtol * np.abs(_np(a)).max(),
                                       err_msg=str(path))
        else:
            _assert_ulps(_np(b), _np(a), ulps, str(path))


def _port_state(js):
    return T.OptState(_torch(js.mu), _torch(js.nu),
                      torch.tensor(int(js.count), dtype=torch.int32))


@pytest.mark.parametrize("clip", [1e9, 1.0], ids=["no-clip", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_over_steps(dtype, clip):
    """Counts 1 to 25 (warmup 5, total 20: warm-up, cosine and past the
    end).  At every count both packages update from identical inputs (JAX's
    state so far, the same gradients): without clipping the outputs agree
    to 2 ulp, with it to rtol 2e-6.  A port state carried on its own stays
    within 1e-6 (2e-5 with clipping) of JAX's."""
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=20, grad_clip=clip)
    rtol = None if clip > 1e6 else SUM_RTOL
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = J.adamw_init(jp), T.adamw_init(tp)
    for count in range(1, 26):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(np.shape(p)) * 0.5).astype(
                np.asarray(p).dtype), params)
        one_p, one_s, one_m = T.adamw_update(
            T.AdamWConfig(**cfg), _torch(grads), _port_state(js), _torch(jp))
        with jax.disable_jit():
            jp, js, jm = J.adamw_update(J.AdamWConfig(**cfg),
                                        jax.tree.map(jnp.asarray, grads), js,
                                        jp)
        tp, ts, _ = T.adamw_update(T.AdamWConfig(**cfg), _torch(grads), ts,
                                   tp)
        assert int(one_s.count) == int(ts.count) == int(js.count) == count
        _assert_ulps(float(one_m["lr"]), float(jm["lr"]), LR_ULPS, "lr")
        np.testing.assert_allclose(float(one_m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=SUM_RTOL)
        # the moments are float32 even for bf16 parameters
        _assert_trees(js.mu, one_s.mu, rtol=rtol)
        _assert_trees(js.nu, one_s.nu, rtol=rtol)
        _assert_trees(jp, one_p, rtol=rtol)
        _assert_trees(jp, tp, rtol=1e-6 if rtol is None else 2e-5)


def test_jitted_jax_skips_the_bf16_rounding_of_the_clipped_gradient():
    """``(g * scale.astype(bf16)).astype(f32)``: op by op (and in the port)
    the product is rounded to bf16; jitted XLA on the CPU keeps it in
    float32.  The two differ by at most half a bf16 ulp of the product."""
    rng = np.random.default_rng(4)
    g = (rng.standard_normal(256) * 0.5).astype(jnp.bfloat16)
    scale = jnp.float32(0.37)

    def fn(g, s):
        return (g * s.astype(g.dtype)).astype(jnp.float32)
    jitted = np.asarray(jax.jit(fn)(g, scale))
    with jax.disable_jit():
        op_by_op = np.asarray(fn(g, scale))
    tg = _torch({"g": g})["g"]
    port = (tg * torch.tensor(0.37).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(port, op_by_op)
    assert not np.array_equal(jitted, op_by_op)
    np.testing.assert_allclose(jitted, op_by_op, rtol=2 ** -8)


def test_stacked_norm_scales_are_decayed_as_in_jax():
    """With a zero gradient, only weight decay moves a parameter: the
    stacked [L, D] ln1 scale and [L, hd] q_norm (2-D) shrink by lr * wd * p,
    the 1-D final norm does not -- in both packages."""
    rng = np.random.default_rng(1)
    params = _tree(rng, "float32")
    zeros = jax.tree.map(np.zeros_like, params)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jp, _, _ = J.adamw_update(J.AdamWConfig(**cfg),
                              jax.tree.map(jnp.asarray, zeros),
                              J.adamw_init(jax.tree.map(jnp.asarray, params)),
                              jax.tree.map(jnp.asarray, params))
    tp0 = _torch(params)
    tp, _, _ = T.adamw_update(T.AdamWConfig(**cfg), _torch(zeros),
                              T.adamw_init(tp0), tp0)
    _assert_trees(jp, tp)
    ln1 = params["blocks"]["ln1"]["scale"]
    lr = float(T.warmup_cosine(T.AdamWConfig(**cfg), torch.tensor(1)))
    np.testing.assert_allclose(_np(tp["blocks"]["ln1"]["scale"]),
                               ln1 - lr * 0.1 * ln1, rtol=1e-6)
    assert not np.array_equal(_np(tp["blocks"]["attn"]["q_norm"]),
                              params["blocks"]["attn"]["q_norm"])
    np.testing.assert_array_equal(_np(tp["final_norm"]["scale"]),
                                  params["final_norm"]["scale"])


@pytest.mark.parametrize("warmup,total", [(1, 10), (20, 100), (100, 50)])
def test_warmup_cosine_matches_jax(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in [0, 1, 5, warmup, warmup + 1, total // 2, total, total + 7]:
        got = float(T.warmup_cosine(T.AdamWConfig(**cfg),
                                    torch.tensor(step, dtype=torch.int32)))
        want = float(J.warmup_cosine(J.AdamWConfig(**cfg),
                                     jnp.asarray(step, jnp.int32)))
        _assert_ulps(got, want, LR_ULPS, step)


@pytest.mark.parametrize("max_norm,scale", [(1.0, 0.5), (1.0, 5.0),
                                            (0.3, 2.0)])
def test_clip_by_global_norm_matches_jax(max_norm, scale):
    """Below and above the clip; the norm sums leaves in jax.tree order."""
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: (p * scale / 20).astype(np.float32),
                         _tree(rng, "float32"))
    jg, jn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                   max_norm)
    tg, tn = T.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=SUM_RTOL)
    np.testing.assert_allclose(float(T.global_norm(_torch(grads))),
                               float(J.global_norm(grads)), rtol=SUM_RTOL)
    _assert_trees(jg, tg, rtol=SUM_RTOL)
