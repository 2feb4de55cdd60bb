"""``repro_torch.models.rwkv6`` against ``repro.models.rwkv6`` at smoke
widths on the CPU (rwkv6-7b-smoke: 2 layers, d_model 128, 2 heads of 64),
with the JAX weights carried across by ``convert.lm_params_from_jax`` and
the float32 parameters (mixing, decay, bonus, norms) perturbed by numpy so
every one matters.

Tolerances (max |logit difference| over every position and step):
  * float32: rtol 1e-5, atol 1e-5 (the WKV loop and JAX's scan sum the
    same float32 products in another order), and greedy tokens equal;
  * bf16: 3% of the largest |logit|: both round every activation to bf16,
    but at other places (JAX's einsums round their outputs, PyTorch's CPU
    bf16 matmuls accumulate in float32), and a flipped rounding of the
    token-shift carry moves the next step.  In decode both sides take
    JAX's tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_smoke_config
from repro.models import build as j_build
from repro.models import rwkv6 as JR
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import build as t_build

ARCH = "rwkv6-7b"
j_forward = jax.jit(JR.forward, static_argnums=0)
_PERTURB = ("scale", "bias", "mu", "w0", "u", "gn_scale", "mu_k", "mu_r")


def _setup(dtype):
    """(jax bundle, port bundle, jax params, port params)."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        JR.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)

    def perturb(node, path=()):
        if isinstance(node, dict):
            return {k: perturb(v, path + (k,)) for k, v in node.items()}
        if path[-1] in _PERTURB:
            base = node.astype(np.float32)
            return (base + 0.1 * rng.standard_normal(base.shape, np.float32)
                    ).astype(node.dtype)
        return node
    tree = perturb(tree)
    return (j_build(jcfg), t_build(tcfg), jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_jax(tree, tcfg, "cpu"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _check(t, j, dtype):
    """Logits (or a state) of the port ``t`` against JAX's ``j``."""
    a, b = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=0.03 * float(np.abs(b).max()))
        return
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_state(dtype):
    jb, tb, jp, tp = _setup(dtype)
    toks = _tokens(jb.cfg, (2, 40))
    jl, js, _ = j_forward(jb.cfg, jp, jnp.asarray(toks))
    tl, ts, aux = tb.forward(tp, torch.from_numpy(toks))
    assert js is None and ts is None and float(aux) == 0.0
    assert tl.dtype == getattr(torch, dtype)
    _check(tl, jl, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
    last, _, _ = tb.forward(tp, torch.from_numpy(toks), logits_slice=1)
    _check(last, jl[:, -1:], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode(dtype):
    """Prefill 12 tokens, then 8 decode steps, from each side's own states:
    logits every step, the states after the prefill (converted to JAX's
    tree) and, in float32, equal greedy tokens."""
    jb, tb, jp, tp = _setup(dtype)
    prompt = _tokens(jb.cfg, (2, 12), seed=1)
    jstate = jb.init_decode_state(2, 20)
    tstate = tb.init_decode_state(2, 20, device="cpu")
    jpre = jax.jit(jserve.make_prefill(jb))
    jdec = jax.jit(jserve.make_decode_step(jb))
    tpre, tdec = tserve.make_prefill(tb), tserve.make_decode_step(tb)
    jl, jstate = jpre(jp, jstate, jnp.asarray(prompt))
    tl, tstate = tpre(tp, tstate, torch.from_numpy(prompt))
    _check(tl, jl, dtype)
    for a, b in zip(convert.states_to_jax(tstate), jstate):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape
        _check(torch.from_numpy(a.astype(np.float32)), b, dtype)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for i in range(8):
        pos = np.full((2, 1), 12 + i, np.int32)
        if dtype == "bfloat16":   # decode the tokens JAX decodes
            ttok = torch.from_numpy(np.array(jtok))
        jtok, jl, jstate = jdec(jp, jstate, jtok, jnp.asarray(pos))
        ttok, tl, tstate = tdec(tp, tstate, ttok, torch.from_numpy(pos))
        _check(tl, jl, dtype)
        if dtype == "float32":
            assert ttok.numpy().tolist() == np.asarray(jtok).tolist()


def test_generate_gives_jax_tokens():
    jb, tb, jp, tp = _setup("float32")
    prompt = _tokens(jb.cfg, (2, 12), seed=4)
    jitted = dataclasses.replace(jb, forward=jax.jit(
        jb.forward, static_argnames=("moe_impl",)))
    want = jserve.generate(jitted, jp, jnp.asarray(prompt), max_new=12,
                           max_len=24)
    got = tserve.generate(tb, tp, prompt, max_new=12, max_len=24,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_from_jax_states():
    """A JAX prefill's states, carried into the port, decode as JAX does;
    the converters round-trip."""
    jb, tb, jp, tp = _setup("float32")
    prompt = _tokens(jb.cfg, (2, 10), seed=2)
    jl, jstate = jax.jit(jserve.make_prefill(jb))(jp, jb.init_decode_state(2, 12),
                                         jnp.asarray(prompt))
    tstate = convert.states_from_jax(jax.tree.map(np.asarray, jstate),
                                     "cpu")
    for a, b in zip(convert.states_to_jax(tstate), jstate):
        assert np.array_equal(a, np.asarray(b))
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    pos = np.full((2, 1), 10, np.int32)
    _, jl2, _ = jax.jit(jserve.make_decode_step(jb))(jp, jstate, jnp.asarray(tok),
                                            jnp.asarray(pos))
    _, tl2, _ = tserve.make_decode_step(tb)(tp, tstate,
                                            torch.from_numpy(tok),
                                            torch.from_numpy(pos))
    _check(tl2, jl2, "float32")


def test_build_states_and_autograd():
    jcfg, tcfg = get_smoke_config(ARCH), t_smoke(ARCH)
    bundle = t_build(tcfg)
    assert bundle.state_kwarg == "states"
    params = bundle.init_params(0, device="cpu")
    assert params["blocks"]["tm"]["wr"].shape[0] == tcfg.num_layers
    jst = j_build(jcfg).init_decode_state(3, 8)
    tst = bundle.init_decode_state(3, 8, device="cpu")
    for a, b in zip(convert.states_to_jax(tst), jst):
        assert a.dtype == b.dtype and a.shape == b.shape and not a.any()
    # under autograd the forward runs the WKV Function: the gradients
    # equal those through the plain pair (executor "reference")
    leaves = (params["blocks"]["tm"]["wr"], params["blocks"]["tm"]["u"],
              params["embed"])
    for leaf in leaves:
        leaf.requires_grad_()
    tokens = torch.arange(12, dtype=torch.long).reshape(2, 6) % 7
    grads = [torch.autograd.grad(bundle.forward(
        params, tokens, executor=ex)[0].float().square().sum(), leaves)
        for ex in ("auto", "reference")]
    for a, b in zip(*grads):
        assert a.abs().max() > 0 and torch.equal(a, b)
    with torch.no_grad():
        assert not bundle.forward(params, tokens)[0].requires_grad


def test_random_lm_params_have_jax_tree_and_scales():
    jcfg, tcfg = get_smoke_config(ARCH), t_smoke(ARCH)
    tree = convert.random_lm_params(tcfg, seed=0)
    want = jax.tree.map(np.asarray, JR.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    tm = tree["blocks"]["tm"]
    assert (tm["mu"] == 0.5).all() and (tm["w0"] == -6.0).all()
    assert (tm["u"] == 0.5).all()
    assert abs(tm["mix_B"].std() / 0.01 - 1) < 0.1
    assert abs(tm["wr"].std() * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(tree["blocks"]["cm"]["wv"].std() * np.sqrt(tcfg.d_ff) - 1) \
        < 0.05
    # JAX's dtypes on conversion: float32 where JAX's init keeps it
    params = convert.lm_params_from_jax(tree, tcfg, "cpu")
    jdt = jax.tree.leaves(jax.tree.map(lambda x: x.dtype, want))
    tdt = [str(t.dtype).replace("torch.", "")
           for t in jax.tree.leaves(params)]
    assert tdt == [str(d) for d in jdt]
    again = convert.random_lm_params(tcfg, seed=0)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(tree), jax.tree.leaves(again)))
