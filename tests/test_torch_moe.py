"""The port's MoE family against the JAX package on the CPU at smoke widths:
qwen3-moe-30b-a3b (128 experts top-8 at full width; here 8 top-2,
qk-norm) and moonshot-v1-16b-a3b (its shared experts), with JAX's weights
carried across by ``convert.lm_params_from_jax``.

Tolerances are test_torch_lm.py's (tests/torch_lm_parity.py).  In bf16 a
token's expert set can flip at a near tie (the k-th and (k+1)-th router
probabilities closer than the two packages' probabilities differ: the
router reads bf16 activations, which JAX's bf16 attention rounds
differently).  Every routing difference is held to such a tie
(``Routing.flips``), and a row's logits are compared up to its first
flipped position; float32 routes identically.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]

j_forward = P.jit_forward(JLM.forward)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_cache_float32(arch):
    """Logits, greedy tokens and the aux loss (summed over layers; rtol
    1e-5) equal JAX's moe_gmm forward, through the port's moe_gmm and
    moe_dense."""
    jcfg, tcfg, jp, tp = P.setup(arch, "float32")
    toks = P.tokens(jcfg, (2, 40))
    jl, _, ja = j_forward(jcfg, jp, jnp.asarray(toks))
    for impl in ("gmm", "dense"):
        tl, tc, ta = TLM.forward(tcfg, tp, torch.from_numpy(toks),
                                 moe_impl=impl)
        assert tc is None and tl.dtype == torch.float32
        P.check_f32(tl, jl)
        assert float(ta) > 0.0
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_cache_bfloat16(arch, monkeypatch):
    jcfg, tcfg, jp, tp = P.setup(arch, "bfloat16")
    routing = P.Routing(monkeypatch)
    toks = P.tokens(jcfg, (2, 40))
    jl, _, ja = P.jit_forward(JLM.forward)(jcfg, jp, jnp.asarray(toks))
    tl, _, ta = TLM.forward(tcfg, tp, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    first = routing.flips(jcfg.moe.top_k, 2, [(0, 40)] * jcfg.num_layers)
    for b, f in enumerate(first):
        P.check_bf16(tl[b, :f], jl[b, :f])
    np.testing.assert_allclose(float(ta), float(ja), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_float32(arch, cache_dtype):
    """Prefill 32 tokens into an empty cache, then 8 decode steps, each
    step's logits held to JAX's."""
    jcfg, tcfg, jp, tp = P.setup(arch, "float32")
    jd = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32
    tol = P.F32_TOL if cache_dtype == "float32" else P.F32_BF16_CACHE_TOL
    toks = P.tokens(jcfg, (2, 40), seed=1)
    jc = JLM.init_caches(jcfg, 2, 48, dtype=jd)
    tc = TLM.init_caches(tcfg, 2, 48, dtype=td, device="cpu")
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :32]), caches=jc)
    tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks[:, :32]),
                            caches=tc)
    P.check_f32(tl, jl, tol)
    for i in range(8):
        pos = np.full((2, 1), 32 + i, np.int32)
        t = toks[:, 32 + i:33 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc)
        tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(t),
                                positions=torch.from_numpy(pos).long(),
                                caches=tc)
        P.check_f32(tl, jl, tol)
    assert tc["idx"] == 40


def test_prefill_then_decode_bfloat16(monkeypatch):
    """bf16 model and caches: prefill 32 tokens, 8 decode steps; each row
    compared up to its first flipped routing."""
    jcfg, tcfg, jp, tp = P.setup("qwen3-moe-30b-a3b", "bfloat16")
    routing = P.Routing(monkeypatch)
    fwd = P.jit_forward(JLM.forward)
    toks = P.tokens(jcfg, (2, 40), seed=2)
    jc = JLM.init_caches(jcfg, 2, 40)
    tc = TLM.init_caches(tcfg, 2, 40, device="cpu")
    jl, jc, _ = fwd(jcfg, jp, jnp.asarray(toks[:, :32]), caches=jc)
    tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks[:, :32]),
                            caches=tc)
    outs = [(tl[:, -1], jl[:, -1], 31)]
    spans = [(0, 32)] * jcfg.num_layers
    for i in range(8):
        pos = np.full((2, 1), 32 + i, np.int32)
        t = toks[:, 32 + i:33 + i]
        jl, jc, _ = fwd(jcfg, jp, jnp.asarray(t),
                        positions=jnp.asarray(pos), caches=jc)
        tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(t),
                                positions=torch.from_numpy(pos).long(),
                                caches=tc)
        outs.append((tl[:, 0], jl[:, 0], 32 + i))
        spans += [(32 + i, 1)] * jcfg.num_layers
    first = routing.flips(jcfg.moe.top_k, 2, spans)
    for t, j, pos in outs:
        rows = np.array([f is None or pos < f for f in first])
        P.check_bf16(t, j, rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    """Weights, expert ids (by falling probability) and the Switch aux loss
    of one router call, float32."""
    jcfg, tcfg, jp, tp = P.setup(arch, "float32")
    xf = np.random.default_rng(5).standard_normal((48, jcfg.d_model),
                                                  np.float32)
    jmoe = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tmoe = {k: v[0] if isinstance(v, torch.Tensor) else v
            for k, v in tp["blocks"]["moe"].items()}
    jw, jids, jaux = JL.moe_router(jcfg, jmoe, jnp.asarray(xf))
    tw, tids, taux = TL.moe_router(tcfg, tmoe, torch.from_numpy(xf))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert tmoe["router"].dtype == torch.float32


def _layer0(jp, tp):
    jmoe = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tmoe = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in tp["blocks"]["moe"].items()}
    return jmoe, tmoe


@pytest.mark.parametrize("arch", ARCHS)
def test_gmm_equals_dense_with_an_empty_expert(arch):
    """moe_gmm (grouped, the port's per-expert loop) against moe_dense and
    against JAX's moe_gmm, with expert 3's router column forced down so
    that no token reaches it (the loop skips it).  moonshot adds its
    shared experts to both."""
    jcfg, tcfg, jp, tp = P.setup(arch, "float32")
    jmoe, tmoe = _layer0(jp, tp)
    # positive inputs against a column of -1: expert 3's logit is -sum(x)
    jmoe["router"] = jmoe["router"].at[:, 3].set(-1.0)
    tmoe["router"] = tmoe["router"].clone()
    tmoe["router"][:, 3] = -1.0
    x = np.abs(np.random.default_rng(6).standard_normal(
        (2, 24, jcfg.d_model), np.float32))
    _, ids, _ = TL.moe_router(tcfg, tmoe, torch.from_numpy(x).reshape(
        48, -1))
    assert not (ids == 3).any() and len(ids.unique()) > 1
    g, ga = TL.moe_gmm(tcfg, tmoe, torch.from_numpy(x))
    d, da = TL.moe_dense(tcfg, tmoe, torch.from_numpy(x))
    jg, jga = JL.moe_gmm(jcfg, jmoe, jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    assert float(ga) == float(da)
    np.testing.assert_allclose(float(ga), float(jga), rtol=1e-5)
    assert ("shared" in tmoe) == (tcfg.moe.num_shared_experts > 0)
    if "shared" in tmoe:
        plain = dict(tmoe)
        del plain["shared"]
        no_shared = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, num_shared_experts=0))
        g0, _ = TL.moe_gmm(no_shared, plain, torch.from_numpy(x))
        shared = TL.mlp(tcfg, tmoe["shared"], torch.from_numpy(x))
        np.testing.assert_allclose(g.numpy(), (g0 + shared).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_bf16_scatter_order_is_ascending_expert_id():
    """In bf16 each token's k weighted expert outputs are added one at a
    time in ascending expert id, each sum rounded to bf16 (JAX's
    ``.at[tok].add`` over the stable sort), whatever order topk gives."""
    tcfg = dataclasses.replace(t_smoke("qwen3-moe-30b-a3b"),
                               dtype="bfloat16")
    tp = TLM.init_params(tcfg, 3, device="cpu")
    moe = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    x = torch.randn(1, 16, tcfg.d_model,
                    generator=torch.Generator().manual_seed(4)).bfloat16()
    got, _ = TL.moe_gmm(tcfg, moe, x)
    xf = x.reshape(16, -1)
    w, ids, _ = TL.moe_router(tcfg, moe, xf)
    want = []
    for n in range(16):
        acc = None
        for s in ids[n].argsort():
            e = int(ids[n, s])
            y = (torch.nn.functional.silu(xf[n] @ moe["wg"][e])
                 * (xf[n] @ moe["wu"][e])) @ moe["wd"][e]
            c = y * w[n, s].to(torch.bfloat16)
            acc = c if acc is None else acc + c
        want.append(acc)
    assert torch.equal(got.reshape(16, -1), torch.stack(want))


def test_a2a_raises_naming_the_multi_card_item():
    """``a2a`` is ported (item 9e.2, tests/test_torch_moe_a2a.py): without
    a mesh it is moe_gmm, as JAX's moe_a2a; an unknown impl still
    raises."""
    tcfg = t_smoke("qwen3-moe-30b-a3b")
    tp = TLM.init_params(tcfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    a2a = TLM.forward(tcfg, tp, toks, moe_impl="a2a")
    gmm = TLM.forward(tcfg, tp, toks, moe_impl="gmm")
    assert torch.equal(a2a[0], gmm[0]) and torch.equal(a2a[2], gmm[2])
    with pytest.raises(ValueError, match="unknown moe_impl"):
        TLM.forward(tcfg, tp, toks, moe_impl="megablocks")
    dense = t_smoke("qwen3-0.6b")      # a dense model has no experts
    TLM.forward(dense, TLM.init_params(dense, 0, device="cpu"), toks,
                moe_impl="a2a")


def test_train_step_matches_jax():
    """One step of the port's make_train_step against JAX's jitted one:
    loss = ce + aux, gradients through the per-expert loop and the
    ascending-id sum, AdamW."""
    js, ts, metrics, g1 = P.run_train_steps("moonshot-v1-16b-a3b")
    assert float(metrics[0][1]["aux"]) > 0.0
    P.check_train(js, ts, metrics, g1)


def test_init_params_fill_the_stack_layer_by_layer():
    """init_params allocates each stacked leaf once and draws layer by
    layer: layer i of the stack equals the i-th init_block drawn after the
    embedding, with the same generator."""
    tcfg = t_smoke("qwen3-moe-30b-a3b")
    tp = TLM.init_params(tcfg, 7, device="cpu")
    gen = torch.Generator().manual_seed(7)
    TL._normal(gen, (tcfg.vocab_size, tcfg.d_model), 0.02, torch.bfloat16)
    for i in range(tcfg.num_layers):
        blk = TLM.init_block(tcfg, gen)
        for name in ("router", "wg", "wd"):
            assert torch.equal(tp["blocks"]["moe"][name][i],
                               blk["moe"][name])
        assert torch.equal(tp["blocks"]["attn"]["wq"][i], blk["attn"]["wq"])
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["wg"].shape == (2, 8, 64, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_random_lm_params_have_jax_tree_and_scales(arch):
    cfg = t_smoke(arch)
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    scales = {"embed": 0.02, "blocks/moe/router": d ** -0.5,
              "blocks/moe/wg": d ** -0.5, "blocks/moe/wd": ff ** -0.5,
              "blocks/attn/wo": d ** -0.5}
    if cfg.moe.num_shared_experts:
        scales["blocks/moe/shared/wd"] = (
            ff * cfg.moe.num_shared_experts) ** -0.5
    P.check_random_tree(arch, scales)


def test_launcher_serves_the_moe_on_the_cpu(capsys):
    toks = tlaunch.main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                         "--device", "cpu", "--batch", "2", "--prompt-len",
                         "8", "--new-tokens", "3"])
    assert toks.shape == (2, 3)
    assert "'flash_attention': 0" in capsys.readouterr().out
    assert tbuild(t_smoke("moonshot-v1-16b-a3b")).state_kwarg == "caches"
    assert convert.random_lm_params(t_smoke("moonshot-v1-16b-a3b"))[
        "blocks"]["moe"]["shared"]["wg"].shape == (2, 64, 96)
