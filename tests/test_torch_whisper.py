"""The port's audio family (whisper-small: encoder-decoder, LayerNorm, GELU,
sinusoidal positions, cross-attention, a padded vocabulary) against the
JAX package on the CPU at smoke widths, with JAX's weights carried across
by ``convert.lm_params_from_jax``.  The smoke vocabulary (512) needs no
padding, so the mask is tested at 509 (padded to 512).  JAX's
``make_decode_step`` passes no ``enc_out`` (ROADMAP queue 3): its decode
is driven here through ``whisper.forward`` with ``enc_out``, as
tests/test_models_smoke.py drives it.  Tolerances are test_torch_lm.py's
(tests/torch_lm_parity.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro.models import whisper as JW
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.models import whisper as TW
from repro_torch.serve import generate

ARCH = "whisper-small"

j_forward = P.jit_forward(JW.forward)
j_encode = jax.jit(JW.encode, static_argnums=0)


def _frames(cfg, B, dtype, seed=3):
    f = np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_positions, cfg.d_model), np.float32)
    return (jnp.asarray(f).astype(jnp.dtype(dtype)),
            torch.from_numpy(f).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, tcfg, jp, tp = P.setup(ARCH, dtype)
    jf, tf = _frames(jcfg, 2, dtype)
    je = j_encode(jcfg, jp, jf)
    te = TW.encode(tcfg, tp, tf)
    assert te.dtype == getattr(torch, dtype) and te.shape == (2, 16, 64)
    if dtype == "float32":
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                                   atol=1e-5)
    else:
        P.check_bf16(te, je)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_cache_masks_the_padded_vocab(dtype):
    jcfg, tcfg, jp, tp = P.setup(ARCH, dtype, vocab_size=509)
    assert TW.padded_vocab(tcfg) == 512 == tp["embed"].shape[0]
    toks = P.tokens(jcfg, (2, 24))
    jf, tf = _frames(jcfg, 2, dtype)
    jl, _, ja = j_forward(jcfg, jp, jnp.asarray(toks), frame_embeds=jf)
    tl, tc, ta = TW.forward(tcfg, tp, torch.from_numpy(toks),
                            frame_embeds=tf)
    assert tc is None and float(ta) == float(ja) == 0.0
    assert tl.shape == (2, 24, 512)
    assert (tl[..., 509:] == torch.tensor(-1e30, dtype=tl.dtype)).all()
    np.testing.assert_array_equal(P.as_np(tl[..., 509:]),
                                  P.as_np(jl[..., 509:]))
    if dtype == "float32":
        P.check_f32(tl, jl)
    else:
        P.check_bf16(tl[..., :509], jl[..., :509])


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_float32(cache_dtype):
    """encode once; prefill 16 tokens into the list of per-layer caches,
    then 8 decode steps, each given ``enc_out``; the caches carried back
    to JAX's list hold JAX's values."""
    jcfg, tcfg, jp, tp = P.setup(ARCH, "float32")
    jd = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32
    tol = P.F32_TOL if cache_dtype == "float32" else P.F32_BF16_CACHE_TOL
    toks = P.tokens(jcfg, (2, 24), seed=1)
    jf, tf = _frames(jcfg, 2, "float32")
    je, te = j_encode(jcfg, jp, jf), TW.encode(tcfg, tp, tf)
    jc = JW.init_caches(jcfg, 2, 32, dtype=jd)
    tc = TW.init_caches(tcfg, 2, 32, dtype=td, device="cpu")
    assert isinstance(tc, list) and len(tc) == tcfg.num_layers
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :16]), caches=jc,
                          enc_out=je)
    tl, tc, _ = TW.forward(tcfg, tp, torch.from_numpy(toks[:, :16]),
                           caches=tc, enc_out=te)
    P.check_f32(tl, jl, tol)
    for i in range(8):
        pos = np.full((2, 1), 16 + i, np.int32)
        t = toks[:, 16 + i:17 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc,
                              enc_out=je)
        tl, tc, _ = TW.forward(tcfg, tp, torch.from_numpy(t),
                               positions=torch.from_numpy(pos).long(),
                               caches=tc, enc_out=te)
        P.check_f32(tl, jl, tol)
    back = convert.caches_to_jax(tc)
    jc = jax.tree.map(np.asarray, jc)
    assert [sorted(c) for c in back] == [sorted(c) for c in jc]
    ctol = 1e-5 if cache_dtype == "float32" else 1e-2
    for b, j in zip(back, jc):
        assert int(b["idx"]) == int(j["idx"]) == 24
        for name in ("k", "v"):
            assert b[name].dtype == j[name].dtype
            np.testing.assert_allclose(np.asarray(b[name], np.float32),
                                       np.asarray(j[name], np.float32),
                                       rtol=ctol, atol=ctol)
    again = convert.caches_from_jax(back, "cpu")
    assert all(torch.equal(a["k"], b["k"]) and a["idx"] == b["idx"]
               for a, b in zip(again, tc))


def test_prefill_then_decode_bfloat16():
    jcfg, tcfg, jp, tp = P.setup(ARCH, "bfloat16")
    toks = P.tokens(jcfg, (2, 20), seed=2)
    jf, tf = _frames(jcfg, 2, "bfloat16")
    je, te = j_encode(jcfg, jp, jf), TW.encode(tcfg, tp, tf)
    jc, tc = JW.init_caches(jcfg, 2, 20), TW.init_caches(tcfg, 2, 20,
                                                          device="cpu")
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :16]), caches=jc,
                          enc_out=je)
    tl, tc, _ = TW.forward(tcfg, tp, torch.from_numpy(toks[:, :16]),
                           caches=tc, enc_out=te)
    P.check_bf16(tl, jl)
    for i in range(4):
        pos = np.full((2, 1), 16 + i, np.int32)
        t = toks[:, 16 + i:17 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc,
                              enc_out=je)
        tl, tc, _ = TW.forward(tcfg, tp, torch.from_numpy(t),
                               positions=torch.from_numpy(pos).long(),
                               caches=tc, enc_out=te)
        P.check_bf16(tl, jl)


def test_generate_passes_enc_out_to_every_step():
    """``serve.generate(..., enc_out=)`` gives the greedy tokens of JAX's
    forward driven step by step with ``enc_out`` (float32)."""
    jcfg, tcfg, jp, tp = P.setup(ARCH, "float32")
    prompt = P.tokens(jcfg, (2, 12), seed=4)
    jf, tf = _frames(jcfg, 2, "float32")
    je = j_encode(jcfg, jp, jf)
    jc = JW.init_caches(jcfg, 2, 20)
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(prompt), caches=jc,
                          enc_out=je)
    want = []
    for i in range(8):
        want.append(np.asarray(jl[:, -1].argmax(-1)))
        if i < 7:
            jl, jc, _ = j_forward(
                jcfg, jp, jnp.asarray(want[-1][:, None]),
                positions=jnp.full((2, 1), 12 + i, jnp.int32), caches=jc,
                enc_out=je)
    bundle = tbuild(tcfg)
    got = generate(bundle, tp, prompt, 8, 20, device="cpu",
                   enc_out=TW.encode(tcfg, tp, tf))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    with pytest.raises(ValueError, match="enc_out"):
        generate(bundle, tp, prompt, 3, 20, device="cpu")


def test_train_step_matches_jax():
    def extra(cfg):
        f = np.random.default_rng(3).standard_normal(
            (4, cfg.encoder_positions, cfg.d_model), np.float32)
        return {"frame_embeds": f}
    js, ts, metrics, g1 = P.run_train_steps(ARCH, batch_kw=extra)
    P.check_train(js, ts, metrics, g1)


def test_remat_on_and_off_give_equal_gradients():
    """Under grad with ``cfg.remat`` every encoder and decoder layer runs
    under torch.utils.checkpoint: the same loss and gradients bit for
    bit."""
    import dataclasses

    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(t_smoke(ARCH), dtype="float32",
                                  remat=remat)
        tp = TW.init_params(cfg, 0, device="cpu")
        leaves = [x.requires_grad_() for x in (
            tp["embed"], tp["enc_layers"][0]["attn"]["wq"],
            tp["dec_layers"][1]["cross_attn"]["wk"])]
        f = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
        logits, _, _ = TW.forward(cfg, tp, torch.zeros((2, 8),
                                                       dtype=torch.long),
                                  frame_embeds=f)
        loss = logits.float().logsumexp(-1).mean()
        out.append([loss.detach()] + list(torch.autograd.grad(loss,
                                                              leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_random_lm_params_have_jax_tree_and_scales():
    cfg = t_smoke(ARCH)
    d = cfg.d_model
    P.check_random_tree(ARCH, {
        "embed": 0.02, "enc_layers/0/attn/wq": d ** -0.5,
        "dec_layers/1/cross_attn/wo": d ** -0.5,
        "dec_layers/0/mlp/wd": cfg.d_ff ** -0.5})


def test_launcher_serves_whisper_on_the_cpu(capsys):
    toks = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "3"])
    assert toks.shape == (2, 3)
    assert "'flash_attention': 0" in capsys.readouterr().out
