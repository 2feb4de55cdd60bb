"""``repro_torch.models`` (the dense LM) against ``repro.models`` at smoke
widths on the CPU: qwen3-0.6b (qk-norm, GQA), qwen2-0.5b (QKV bias, GQA)
and olmo-1b (``ln_nonparam``), with the JAX weights carried across by
``convert.lm_params_from_jax``.

Tolerances (max |logit difference| over every position and step):
  * float32 model, float32 caches: rtol 1e-5, atol 1e-5 (measured worst
    8.4e-7 on logits of magnitude ~0.7);
  * float32 model, bf16 caches (JAX's default): rtol 1e-4, atol 2e-4.  The
    keys are rounded to bf16 on their way into the cache; a last-ulp
    float32 difference straddles a bf16 rounding midpoint for about 1 in
    10^4 elements, which moves the next logits by up to 9e-5 (measured);
  * bf16 model: 3% of the largest |logit| (measured worst 1.4%): JAX rounds
    attention scores and probabilities to bf16, the kernel and its plain
    version keep them in float32 (ROADMAP queue 3).
Greedy tokens are equal in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import build as t_build
from repro_torch.models import lm as TLM

ARCHS = ["qwen3-0.6b", "qwen2-0.5b", "olmo-1b"]

# JAX's forward, jitted with the config static: one compile per shape
j_forward = jax.jit(JLM.forward, static_argnums=0)


def _setup(arch, dtype):
    """(jax cfg, port cfg, jax params, port params), JAX's init with the
    biases and norm scales perturbed by numpy so every parameter matters."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        JLM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)

    def perturb(node, path=()):
        if isinstance(node, dict):
            return {k: perturb(v, path + (k,)) for k, v in node.items()}
        if path[-1] in ("bq", "bk", "bv", "scale", "bias", "q_norm",
                        "k_norm"):
            base = node.astype(np.float32)
            return (base + 0.1 * rng.standard_normal(base.shape, np.float32)
                    ).astype(node.dtype)
        return node
    tree = perturb(tree)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, convert.lm_params_from_jax(tree, tcfg, "cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _logits(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(t, j, dtype, caches="float32"):
    a, b = _logits(t), _logits(j)
    if dtype == "bfloat16":
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=0.03 * float(np.abs(b).max()))
        return
    tol = dict(rtol=1e-5, atol=1e-5) if caches == "float32" else \
        dict(rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(a, b, **tol)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_cache(arch, dtype):
    jcfg, tcfg, jp, tp = _setup(arch, dtype)
    toks = _tokens(jcfg, (2, 40))
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks))
    tl, tc, aux = TLM.forward(tcfg, tp, torch.from_numpy(toks))
    assert jc is None and tc is None and float(aux) == 0.0
    assert tl.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    _check(tl, jl, dtype)
    # logits_slice: the last positions' logits only, same values
    ts, _, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks), logits_slice=3)
    np.testing.assert_allclose(_logits(ts), _logits(tl)[:, -3:], rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_row", [False, True], ids=["contiguous",
                                                        "per_row"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_float32(arch, per_row, cache_dtype):
    """Prefill 32 tokens into an empty cache (the kernel's site), then 8
    decode steps over the cache, each step's logits held to JAX's."""
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    jd = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32
    toks = _tokens(jcfg, (2, 40), seed=1)
    jc = JLM.init_caches(jcfg, 2, 48, dtype=jd, per_row=per_row)
    tc = TLM.init_caches(tcfg, 2, 48, dtype=td, per_row=per_row,
                         device="cpu")
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :32]), caches=jc)
    tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks[:, :32]),
                            caches=tc)
    _check(tl, jl, "float32", cache_dtype)
    assert tc["idx"] == 32 and int(jc["idx"][0]) == 32
    for i in range(8):
        pos = np.full((2, 1), 32 + i, np.int32)
        t = toks[:, 32 + i:33 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc)
        tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(t),
                                positions=torch.from_numpy(pos).long(),
                                caches=tc)
        _check(tl, jl, "float32", cache_dtype)
    # the caches carried back to JAX's layout hold JAX's values
    back = convert.caches_to_jax(tc)
    assert sorted(back) == sorted(jax.tree.map(np.asarray, jc))
    tol = 1e-5 if cache_dtype == "float32" else 1e-2
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(back[name], np.float32),
                                   np.asarray(jc[name], np.float32),
                                   rtol=tol, atol=tol)
    np.testing.assert_array_equal(back["idx"], np.asarray(jc["idx"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_bfloat16(arch):
    jcfg, tcfg, jp, tp = _setup(arch, "bfloat16")
    toks = _tokens(jcfg, (2, 36), seed=2)
    jc = JLM.init_caches(jcfg, 2, 40)
    tc = TLM.init_caches(tcfg, 2, 40, device="cpu")
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :32]), caches=jc)
    tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks[:, :32]),
                            caches=tc)
    _check(tl, jl, "bfloat16")
    for i in range(4):
        pos = np.full((2, 1), 32 + i, np.int32)
        t = toks[:, 32 + i:33 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc)
        tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(t),
                                positions=torch.from_numpy(pos).long(),
                                caches=tc)
        _check(tl, jl, "bfloat16")


def test_caches_from_jax_round_trip():
    jcfg = get_smoke_config("qwen3-0.6b")
    rng = np.random.default_rng(3)
    jc = JLM.init_caches(jcfg, 2, 8, per_row=True)
    jc = dict(jc, k=jnp.asarray(rng.standard_normal(jc["k"].shape,
                                                    np.float32)
                                ).astype(jnp.bfloat16),
              idx=jnp.full_like(jc["idx"], 5))
    tc = convert.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["per_row"] and tc["idx"] == 5 and tc["k"].dtype == torch.bfloat16
    back = convert.caches_to_jax(tc)
    for name, leaf in jax.tree.map(np.asarray, jc).items():
        assert back[name].dtype == leaf.dtype, name
        np.testing.assert_array_equal(back[name], leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_random_lm_params_have_jax_tree_and_scales(arch):
    cfg = get_smoke_config(arch)
    tcfg = t_smoke(arch)
    shapes = jax.eval_shape(lambda: JLM.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    tree = convert.random_lm_params(tcfg, seed=0)
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert tuple(a.shape) == b.shape and b.dtype == np.float32, path
    tp = convert.lm_params_from_jax(tree, tcfg, "cpu")
    flat_p = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    for (path, a), (_, b) in zip(flat_j, flat_p):
        assert str(b.dtype) == f"torch.{a.dtype}", path
    # JAX's init scales: embed 0.02, attention 1/sqrt(d), wd 1/sqrt(d_ff)
    assert abs(tree["embed"].std() - 0.02) < 0.002
    wq = tree["blocks"]["attn"]["wq"]
    assert abs(wq.std() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    wd = tree["blocks"]["mlp"]["wd"]
    assert abs(wd.std() * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    again = convert.random_lm_params(tcfg, seed=0)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(tree), jax.tree.leaves(again)))


def test_build_serves_dense_and_names_the_rest():
    bundle = t_build(t_smoke("qwen3-0.6b"))
    assert bundle.state_kwarg == "caches"
    params = bundle.init_params(0, device="cpu")
    assert params["blocks"]["attn"]["wq"].shape[0] == 2
    st = bundle.init_decode_state(2, 8, device="cpu")
    assert st["k"].dtype == torch.bfloat16 and st["idx"] == 0
    # every family builds (MoE, VLM and whisper since item 9e's first
    # part); the MoE's expert-parallel a2a names its multi-card item
    for arch in ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "qwen2-vl-2b",
                 "whisper-small"):
        b = t_build(t_smoke(arch))
        assert b.state_kwarg == "caches"
        kw = ({"frame_embeds": torch.zeros((1, 16, 64))}
              if arch == "whisper-small" else {})
        b.forward(b.init_params(0, device="cpu"),
                  torch.zeros((1, 4), dtype=torch.long), **kw)
    moe = t_build(t_smoke("qwen3-moe-30b-a3b"))
    mp = moe.init_params(0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    # expert parallelism (item 9e.2) is moe_gmm without a mesh, as JAX's
    assert torch.equal(moe.forward(mp, toks, moe_impl="a2a")[0],
                       moe.forward(mp, toks, moe_impl="gmm")[0])
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):     # served since 9c/9d
        assert t_build(t_smoke(arch)).state_kwarg == "states"


def test_configs_are_the_jax_packages():
    from repro import configs as jconf
    from repro_torch import configs as tconf

    assert jconf.ARCHS == tconf.ARCHS and jconf.SHAPES == tconf.SHAPES
    for arch in jconf.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            a = getattr(jconf, get)(arch)
            b = getattr(tconf, get)(arch)
            assert dataclasses.astuple(a) == dataclasses.astuple(b), arch
        assert jconf.cells(arch) == tconf.cells(arch)
        assert a.param_count() == b.param_count()
