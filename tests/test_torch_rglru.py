"""``repro_torch.models.rglru`` against ``repro.models.rglru`` at smoke
widths on the CPU (recurrentgemma-smoke: 6 layers in the pattern rglru,
rglru, local; d_model 64; 4 query heads and 1 key/value head of 16; window
16), with the JAX weights carried across by ``convert.lm_params_from_jax``
and the norm scales and Λ perturbed by numpy so every one matters.  Also
the ring-buffer cache (a decode that wraps it, a prefill longer than it)
and kernel 2's plain version at recurrentgemma's head width of 256.

Tolerances (max |logit difference| over every position and step):
  * float32: rtol 1e-5, atol 1e-5, greedy tokens equal.  The RG-LRU runs
    the sequential recurrence where JAX runs an associative scan (ROADMAP
    queue 3): the two round differently in the last float32 bits;
  * bf16: 6% of the largest |logit| (measured worst 3.8%, over the forward
    and 25 serving steps; the dense LM's measured 1.4%).  JAX's einsums
    round attention scores and products to bf16 where the port's plain
    versions keep float32, and this smoke model's logits are small (the
    largest ~0.7), so one bf16 ulp of a hidden state is a larger share of
    them.  In decode both sides take JAX's tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_smoke_config
from repro.kernels.flash_attention import flash_attention as j_fa
from repro.kernels.flash_attention import flash_attention_ref as j_fa_ref
from repro.models import build as j_build
from repro.models import layers as JL
from repro.models import rglru as JR
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build as t_build
from repro_torch.models import layers as TL

ARCH = "recurrentgemma-2b"
j_forward = jax.jit(JR.forward, static_argnums=0)


def _setup(dtype):
    """(jax bundle, port bundle, jax params, port params)."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        JR.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(12)

    def perturb(node, key=None):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        if key in ("scale", "lam", "b", "conv_b"):
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
                                   atol=0.06 * float(np.abs(b).max()))
        return
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _states_close(t, j, dtype):
    """The port's decode states against JAX's, leaf by leaf (ring caches
    with their positions and write offsets exactly).  Under a float32
    model the bf16 leaves (JAX's default caches and carries) may differ by
    one bf16 ulp: a last-bit float32 difference can straddle a bf16
    rounding midpoint (ROADMAP queue 3, "bf16 caches under a float32
    model")."""
    tj = convert.states_to_jax(t)
    assert len(tj) == len(j)
    for a, b in zip(tj, j):
        if isinstance(b, dict):
            assert int(a["idx"]) == int(b["idx"])
            assert np.array_equal(a["pos"], np.asarray(b["pos"]))
            a, b = (a["k"], a["v"]), (b["k"], b["v"])
        for x, y in zip(a, b):
            assert x.dtype == np.asarray(y).dtype and x.shape == y.shape
            if dtype == "float32" and x.dtype != np.float32:
                np.testing.assert_allclose(x.astype(np.float32),
                                           np.asarray(y, np.float32),
                                           rtol=2.0 ** -7, atol=1e-5)
            else:
                _check(torch.from_numpy(x.astype(np.float32)), y, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_state(dtype):
    jb, tb, jp, tp = _setup(dtype)
    toks = _tokens(jb.cfg, (2, 40))      # longer than the window of 16
    jl, js, _ = j_forward(jb.cfg, jp, jnp.asarray(toks))
    tl, ts, aux = tb.forward(tp, torch.from_numpy(toks))
    assert js is None and ts is None and float(aux) == 0.0
    assert tl.dtype == getattr(torch, dtype)
    _check(tl, jl, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_wraps_the_ring(dtype):
    """12 prompt tokens into rings of 16 (window 16, max_len 40), then 24
    decode steps: the ring wraps at position 16.  Logits every step and the
    states after the prefill and at the end; greedy tokens equal in
    float32."""
    jb, tb, jp, tp = _setup(dtype)
    prompt = _tokens(jb.cfg, (2, 12), seed=1)
    jstate = jb.init_decode_state(2, 40)
    tstate = tb.init_decode_state(2, 40, device="cpu")
    assert tstate[2]["k"].shape[1] == 16
    jpre = jax.jit(jserve.make_prefill(jb))
    jdec = jax.jit(jserve.make_decode_step(jb))
    tpre, tdec = tserve.make_prefill(tb), tserve.make_decode_step(tb)
    jl, jstate = jpre(jp, jstate, jnp.asarray(prompt))
    tl, tstate = tpre(tp, tstate, torch.from_numpy(prompt))
    _check(tl, jl, dtype)
    _states_close(tstate, jstate, dtype)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for i in range(24):
        pos = np.full((2, 1), 12 + i, np.int32)
        if dtype == "bfloat16":   # decode the tokens JAX decodes
            ttok = torch.from_numpy(np.array(jtok))
        jtok, jl, jstate = jdec(jp, jstate, jtok, jnp.asarray(pos))
        ttok, tl, tstate = tdec(tp, tstate, ttok, torch.from_numpy(pos))
        _check(tl, jl, dtype)
        if dtype == "float32":
            assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
    assert tstate[2]["idx"] == 36 and int(tstate[2]["pos"].min()) == 20
    _states_close(tstate, jstate, dtype)


def test_generate_gives_jax_tokens_across_the_ring():
    jb, tb, jp, tp = _setup("float32")
    prompt = _tokens(jb.cfg, (2, 12), seed=4)
    jitted = dataclasses.replace(jb, forward=jax.jit(
        jb.forward, static_argnames=("moe_impl",)))
    want = jserve.generate(jitted, jp, jnp.asarray(prompt), max_new=24,
                           max_len=40)
    got = tserve.generate(tb, tp, prompt, max_new=24, max_len=40,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_longer_than_the_ring_raises_as_in_jax():
    jb, tb, jp, tp = _setup("float32")
    prompt = _tokens(jb.cfg, (1, 24), seed=5)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jax.jit(jserve.make_prefill(jb))(jp, jb.init_decode_state(1, 40),
                                jnp.asarray(prompt))
    with pytest.raises(ValueError, match="ring cache overflow"):
        tserve.make_prefill(tb)(tp, tb.init_decode_state(1, 40,
                                                         device="cpu"),
                                torch.from_numpy(prompt))


def test_decode_from_jax_states():
    """A JAX prefill's states (rings and recurrences), carried into the
    port, decode as JAX does; the converters round-trip."""
    jb, tb, jp, tp = _setup("float32")
    prompt = _tokens(jb.cfg, (2, 10), seed=2)
    jl, jstate = jax.jit(jserve.make_prefill(jb))(jp, jb.init_decode_state(2, 30),
                                         jnp.asarray(prompt))
    jnp_state = jax.tree.map(np.asarray, jstate)
    tstate = convert.states_from_jax(jnp_state, "cpu")
    for a, b in zip(jax.tree.leaves(convert.states_to_jax(tstate)),
                    jax.tree.leaves(jnp_state)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    pos = np.full((2, 1), 10, np.int32)
    _, jl2, _ = jax.jit(jserve.make_decode_step(jb))(jp, jstate, jnp.asarray(tok),
                                            jnp.asarray(pos))
    _, tl2, _ = tserve.make_decode_step(tb)(tp, tstate,
                                            torch.from_numpy(tok),
                                            torch.from_numpy(pos))
    _check(tl2, jl2, "float32")


def test_ring_attention_layer_matches_jax():
    """The local-attention layer alone: a prefill into an empty ring, then
    decode steps past its end, against JAX's attention with a ring cache."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="float32")
    p = JL.init_attention(jcfg, jax.random.PRNGKey(3))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, p), tcfg,
                                    "cpu")
    rng = np.random.default_rng(8)
    jc = JL.init_cache(jcfg, 2, 8, jnp.float32, ring=True)
    tc = TL.init_cache(tcfg, 2, 8, torch.float32, ring=True)
    x = rng.standard_normal((2, 6, tcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6))
    jy, jc = JL.attention(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                          window=5, cache=jc)
    ty, tc = TL.attention(tcfg, tp, torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), window=5, cache=tc,
                          from_start=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    for t in range(6, 14):
        x = rng.standard_normal((2, 1, tcfg.d_model), np.float32)
        pos = np.full((2, 1), t, np.int32)
        jy, jc = JL.attention(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                              window=5, cache=jc)
        ty, tc = TL.attention(tcfg, tp, torch.from_numpy(x),
                              torch.from_numpy(pos), window=5, cache=tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    with pytest.raises(ValueError, match="ring cache overflow"):
        TL.attention(tcfg, tp, torch.zeros(2, 3, tcfg.d_model),
                     torch.zeros(2, 3, dtype=torch.long), window=5,
                     cache=tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window", [(256, 64), (128, 0), (130, 0)])
def test_flash_attention_hd256_mqa_matches_jax(dtype, T, window):
    """Kernel 2's plain version at recurrentgemma's heads (10 query heads,
    1 key/value head of 256), causal with and without a window, against
    JAX's Pallas kernel in interpret mode where T fills its 128-row blocks,
    and against JAX's oracle where it does not: interpret mode pads a
    partial block with NaN, which reaches the output rows of that block
    (ROADMAP queue 3).  Tolerances of tests/test_kernels.py: float32 2e-5,
    bf16 2e-2."""
    rng = np.random.default_rng(T)
    xs = [rng.standard_normal((1, T, h, 256), np.float32)
          for h in (10, 1, 1)]
    jx = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs]
    if T % 128:
        assert np.isnan(np.asarray(j_fa(*jx, causal=True, window=window,
                                        interpret=True), np.float32)).any()
        want = j_fa_ref(*jx, causal=True, window=window)
    else:
        want = j_fa(*jx, causal=True, window=window, interpret=True)
    got = flash_attention(*[torch.from_numpy(x).to(getattr(torch, dtype))
                            for x in xs], causal=True, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_build_states_and_autograd():
    jcfg, tcfg = get_smoke_config(ARCH), t_smoke(ARCH)
    bundle = t_build(tcfg)
    assert bundle.state_kwarg == "states"
    params = bundle.init_params(0, device="cpu")
    assert len(params["layers"]) == tcfg.num_layers
    assert "attn" in params["layers"][2] and "rec" in params["layers"][0]
    jst = jax.tree.map(np.asarray, j_build(jcfg).init_decode_state(3, 8))
    tst = convert.states_to_jax(bundle.init_decode_state(3, 8,
                                                         device="cpu"))
    assert jax.tree.structure(tst) == jax.tree.structure(jst)
    for a, b in zip(jax.tree.leaves(tst), jax.tree.leaves(jst)):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b)
    params["layers"][0]["rec"]["wx"].requires_grad_()
    logits, _, _ = bundle.forward(params, torch.zeros((1, 4),
                                                      dtype=torch.long))
    (g,) = torch.autograd.grad(logits.sum(), params["layers"][0]["rec"]["wx"])
    assert g.shape == params["layers"][0]["rec"]["wx"].shape
    with torch.no_grad():
        nograd, _, _ = bundle.forward(params, torch.zeros((1, 4),
                                                          dtype=torch.long))
    assert torch.equal(nograd, logits.detach())


def test_random_lm_params_have_jax_tree_and_scales():
    jcfg, tcfg = get_smoke_config(ARCH), t_smoke(ARCH)
    tree = convert.random_lm_params(tcfg, seed=0)
    want = jax.tree.map(np.asarray, JR.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    rec = tree["layers"][0]["rec"]
    np.testing.assert_allclose(rec["lam"], want["layers"][0]["rec"]["lam"],
                               rtol=1e-6)
    assert abs(rec["conv_w"].std() / 0.1 - 1) < 0.2
    bd = tcfg.lru_width // 8
    assert abs(rec["gate_a"]["w"].std() * np.sqrt(bd) - 1) < 0.1
    params = convert.lm_params_from_jax(tree, tcfg, "cpu")
    jdt = jax.tree.leaves(jax.tree.map(lambda x: x.dtype, want))
    tdt = [str(t.dtype).replace("torch.", "")
           for t in jax.tree.leaves(params)]
    assert tdt == [str(d) for d in jdt]
