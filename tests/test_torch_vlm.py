"""The port's VLM family (qwen2-vl-2b's text backbone: QKV bias, M-RoPE,
patch embeddings through ``vision_embeds``) against the JAX package on the
CPU at smoke widths, with JAX's weights carried across by
``convert.lm_params_from_jax``.

The smoke config's head (16) truncates ``mrope_sections`` (16, 24, 24) to
the first section, and one ``arange`` broadcast into the three rows makes
M-RoPE plain RoPE; so these tests fit the sections to the head ((2, 3, 3)
over its 8 rotary dims) and lay out Qwen2-VL's positions: an image grid of
rows x cols patches (t = 0, h = row, w = col), then the text at t = h = w
= max(rows, cols) + i.  Tolerances are test_torch_lm.py's
(tests/torch_lm_parity.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import generate

ARCH = "qwen2-vl-2b"
SECTIONS = (2, 3, 3)
GRID = (2, 4)                   # image rows x cols: the first 8 slots

j_forward = P.jit_forward(JLM.forward)


def mrope_positions(B, T, grid=GRID):
    """[3, B, T] int32: the grid's patches, then text."""
    rows, cols = grid
    r, c = np.divmod(np.arange(rows * cols), cols)
    text = max(rows, cols) + np.arange(T - rows * cols)
    pos = np.stack([np.concatenate([np.zeros(rows * cols, int), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.broadcast_to(pos[:, None], (3, B, T)).astype(np.int32)


def _inputs(cfg, B, T, seed=3):
    ve = np.random.default_rng(seed).standard_normal(
        (B, GRID[0] * GRID[1], cfg.d_model), np.float32)
    return ve, mrope_positions(B, T)


def test_mrope_cos_sin_matches_jax_and_is_not_rope():
    pos = mrope_positions(2, 24)
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos), SECTIONS, 16, 1e6)
    tc, tsn = TL.mrope_cos_sin(torch.from_numpy(pos), SECTIONS, 16, 1e6)
    # the angles agree; XLA's cos and sin differ from torch's in the last
    # bit: 2 float32 ulps of 1
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(js), rtol=0,
                               atol=2.4e-7)
    # the image slots take their h and w rows: not RoPE at the text row
    rc, _ = TL.rope_cos_sin(torch.from_numpy(pos[0]), 16, 1e6)
    assert not torch.equal(tc[:, :, 0], rc)
    with pytest.raises(ValueError, match="cover 4 of 8"):
        TL.mrope_cos_sin(torch.from_numpy(pos), (1, 2, 1), 16, 1e6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_cache(dtype):
    jcfg, tcfg, jp, tp = P.setup(ARCH, dtype, mrope_sections=SECTIONS)
    toks = P.tokens(jcfg, (2, 24))
    ve, mp = _inputs(jcfg, 2, 24)
    jl, _, ja = j_forward(jcfg, jp, jnp.asarray(toks),
                          vision_embeds=jnp.asarray(ve),
                          mrope_pos=jnp.asarray(mp))
    tl, _, ta = TLM.forward(tcfg, tp, torch.from_numpy(toks),
                            vision_embeds=torch.from_numpy(ve),
                            mrope_pos=torch.from_numpy(mp))
    assert float(ta) == float(ja) == 0.0
    if dtype == "float32":
        P.check_f32(tl, jl)
    else:
        P.check_bf16(tl, jl)
    # the vision embeddings and M-RoPE both reach the logits
    plain, _, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks))
    rope, _, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks),
                             vision_embeds=torch.from_numpy(ve))
    assert not torch.equal(plain, rope) and not torch.equal(rope, tl)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_float32(cache_dtype):
    """Prefill 24 tokens with the image and M-RoPE, then 8 decode steps on
    plain positions (JAX's decode passes positions only)."""
    jcfg, tcfg, jp, tp = P.setup(ARCH, "float32", mrope_sections=SECTIONS)
    jd = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32
    tol = P.F32_TOL if cache_dtype == "float32" else P.F32_BF16_CACHE_TOL
    toks = P.tokens(jcfg, (2, 32), seed=1)
    ve, mp = _inputs(jcfg, 2, 24)
    jc = JLM.init_caches(jcfg, 2, 40, dtype=jd)
    tc = TLM.init_caches(tcfg, 2, 40, dtype=td, device="cpu")
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :24]), caches=jc,
                          vision_embeds=jnp.asarray(ve),
                          mrope_pos=jnp.asarray(mp))
    tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks[:, :24]),
                            caches=tc, vision_embeds=torch.from_numpy(ve),
                            mrope_pos=torch.from_numpy(mp))
    P.check_f32(tl, jl, tol)
    for i in range(8):
        pos = np.full((2, 1), 24 + i, np.int32)
        t = toks[:, 24 + i:25 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc)
        tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(t),
                                positions=torch.from_numpy(pos).long(),
                                caches=tc)
        P.check_f32(tl, jl, tol)


def test_prefill_then_decode_bfloat16_and_generate():
    """bf16 model and caches; then ``serve.generate`` with the image and
    M-RoPE positions passed to its prefill gives JAX's greedy tokens in
    float32."""
    jcfg, tcfg, jp, tp = P.setup(ARCH, "bfloat16", mrope_sections=SECTIONS)
    toks = P.tokens(jcfg, (2, 28), seed=2)
    ve, mp = _inputs(jcfg, 2, 24)
    jc, tc = JLM.init_caches(jcfg, 2, 28), TLM.init_caches(tcfg, 2, 28,
                                                            device="cpu")
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(toks[:, :24]), caches=jc,
                          vision_embeds=jnp.asarray(ve),
                          mrope_pos=jnp.asarray(mp))
    tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(toks[:, :24]),
                            caches=tc, vision_embeds=torch.from_numpy(ve),
                            mrope_pos=torch.from_numpy(mp))
    P.check_bf16(tl, jl)
    for i in range(4):
        pos = np.full((2, 1), 24 + i, np.int32)
        t = toks[:, 24 + i:25 + i]
        jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(t),
                              positions=jnp.asarray(pos), caches=jc)
        tl, tc, _ = TLM.forward(tcfg, tp, torch.from_numpy(t),
                                positions=torch.from_numpy(pos).long(),
                                caches=tc)
        P.check_bf16(tl, jl)

    jcfg, tcfg, jp, tp = P.setup(ARCH, "float32", mrope_sections=SECTIONS)
    prompt = toks[:, :24]
    want, jc = [], JLM.init_caches(jcfg, 2, 30)
    jl, jc, _ = j_forward(jcfg, jp, jnp.asarray(prompt), caches=jc,
                          vision_embeds=jnp.asarray(ve),
                          mrope_pos=jnp.asarray(mp))
    for i in range(6):
        want.append(np.asarray(jl[:, -1].argmax(-1)))
        if i < 5:
            jl, jc, _ = j_forward(
                jcfg, jp, jnp.asarray(want[-1][:, None]),
                positions=jnp.full((2, 1), 24 + i, jnp.int32), caches=jc)
    got = generate(tbuild(tcfg), tp, prompt, 6, 30, device="cpu",
                   vision_embeds=torch.from_numpy(ve),
                   mrope_pos=torch.from_numpy(mp))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


def test_train_step_matches_jax():
    def extra(cfg):
        ve, mp = _inputs(cfg, 4, 32)
        return {"vision_embeds": ve, "mrope_pos": mp}
    js, ts, metrics, g1 = P.run_train_steps(ARCH, batch_kw=extra,
                                            mrope_sections=SECTIONS)
    P.check_train(js, ts, metrics, g1)


def test_random_lm_params_have_jax_tree_and_scales():
    cfg = t_smoke(ARCH)
    d = cfg.d_model
    P.check_random_tree(ARCH, {"embed": 0.02, "blocks/attn/wq": d ** -0.5,
                               "blocks/mlp/wd": cfg.d_ff ** -0.5})


def test_launcher_serves_the_vlm_on_the_cpu():
    toks = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "3"])
    assert toks.shape == (2, 3)
