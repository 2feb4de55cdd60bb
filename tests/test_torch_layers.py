"""Each ported function of ``repro/models/layers.py`` against JAX at smoke
widths, on the CPU, with inputs and parameters drawn by numpy.

Tolerances.  float32: rtol 2e-6 with atol 2e-6 for entries near zero
(XLA and PyTorch sum in different orders and differ in the last ulp of
``pow``/``cos``/``sin``).  bf16: every element within 2% of the tensor's
largest magnitude, about two bf16 ulps of it (values are rounded to bf16
at the same points, but a last-ulp float32 difference inside a product can
round either way and carry through the next bf16 op).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=2e-6, atol=2e-6)
BF16_TOL = 2e-2   # of the largest magnitude


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(t_smoke(arch), dtype=dtype, **kw))


def _pair(x, dtype="float32"):
    """One numpy array as (jax, torch) in ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(x).long()
    return jnp.asarray(x), torch.from_numpy(x)


def _close(t, j, dtype="float32", bf16_tol=BF16_TOL):
    got, want = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=bf16_tol * float(np.abs(want).max()))


def _attn_params(cfg, rng, dtype):
    """Random attention params (biases and qk-norm scales too)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    s = np.float32(1.0 / np.sqrt(d))
    p = {"wq": rng.standard_normal((d, h * hd), np.float32) * s,
         "wk": rng.standard_normal((d, hkv * hd), np.float32) * s,
         "wv": rng.standard_normal((d, hkv * hd), np.float32) * s,
         "wo": rng.standard_normal((h * hd, d), np.float32) * s}
    if cfg.qkv_bias:
        for n, w in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[n] = rng.standard_normal((w * hd,), np.float32) * 0.1
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            v = 1.0 + 0.1 * rng.standard_normal((hd,), np.float32)
            jp[n], tp[n] = _pair(v)
    return jp, tp


@pytest.mark.parametrize("norm_type", ["rmsnorm", "ln", "ln_nonparam"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(norm_type, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3 + 0.5
    p = {}
    if norm_type != "ln_nonparam":
        p["scale"] = 1.0 + 0.1 * rng.standard_normal(64, np.float32)
    if norm_type == "ln":
        p["bias"] = 0.1 * rng.standard_normal(64, np.float32)
    jx, tx = _pair(x, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(TL._norm_impl(norm_type, tp, tx), JL._norm_impl(norm_type, jp, jx),
           dtype)
    s = 1.0 + 0.1 * rng.standard_normal(16, np.float32)
    hx = rng.standard_normal((2, 5, 4, 16), np.float32)
    jh, th = _pair(hx, dtype)
    _close(TL.rms_head_norm(th, torch.from_numpy(s)),
           JL.rms_head_norm(jh, jnp.asarray(s)), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    pos = np.array([[0, 1, 7, 300], [5, 6, 1000, 4095]], np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, theta)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos).long(), 32, theta)
    # last-ulp differences of pow and cos/sin between XLA and torch
    # (measured 6e-8 absolute on these angles)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 4, 3, 32), np.float32)
    jx, tx = _pair(x)
    _close(TL.apply_rope(tx, tc[:, :, None], ts[:, :, None]),
           JL.apply_rope(jx, jc[:, :, None], js[:, :, None]))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-0.5b"])
def test_qkv_and_scores_full(arch):
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(jcfg, rng, "float32")
    x = rng.standard_normal((2, 6, jcfg.d_model), np.float32)
    jx, tx = _pair(x)
    jq, jk, jv = JL._qkv(jcfg, jp, jx)
    tq, tk, tv = TL._qkv(tcfg, tp, tx)
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        _close(a, b)
    m = rng.random((2, 1, 1, 6, 6)) < 0.3
    bias = np.where(m, JL.NEG_INF, 0.0).astype(np.float32)
    _close(TL.attention_scores_full(tq, tk, tv, torch.from_numpy(bias)),
           JL.attention_scores_full(jq, jk, jv, jnp.asarray(bias)))


@pytest.mark.parametrize("window", [0, 24])
def test_attention_chunked_long_query(window):
    """Tq > q_chunk: JAX's chunked branch, several query chunks each over
    its reachable keys, against the flash-attention wrapper that replaces
    it in the port (the plain version on the CPU)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 96, 4, 16), np.float32)
    k = rng.standard_normal((2, 96, 2, 16), np.float32)
    v = rng.standard_normal((2, 96, 2, 16), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(k), _pair(v)
    for causal in (True, False):
        # JAX ignores the window without the causal mask
        got = flash_attention(tq, tk, tv, causal=causal,
                              window=window if causal else 0)
        want = JL.attention_chunked(jq, jk, jv, causal=causal, window=window,
                                    q_chunk=32)
        _close(got, want)


@pytest.mark.parametrize("T", [1, 40, 200])
def test_attention_without_cache_non_causal(T):
    """Non-causal attention, past the kernel's K block too: full scores,
    as JAX computes them for a short sequence."""
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    rng = np.random.default_rng(8)
    jp, tp = _attn_params(jcfg, rng, "float32")
    x = rng.standard_normal((2, T, jcfg.d_model), np.float32)
    pos = np.zeros((2, T), np.int32)
    jy, _ = JL.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                         causal=False)
    ty, _ = TL.attention(tcfg, tp, torch.from_numpy(x),
                         torch.from_numpy(pos).long(), causal=False)
    _close(ty, jy)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-0.5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_without_cache(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(4)
    jp, tp = _attn_params(jcfg, rng, dtype)
    for T in (1, 40):
        x = rng.standard_normal((2, T, jcfg.d_model), np.float32)
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
        jx, tx = _pair(x, dtype)
        jy, _ = JL.attention(jcfg, jp, jx, jnp.asarray(pos))
        ty, _ = TL.attention(tcfg, tp, tx, torch.from_numpy(pos).long())
        # bf16: JAX rounds the scores and probabilities to bf16, the kernel
        # keeps them in float32 (ROADMAP queue 3)
        _close(ty, jy, dtype, bf16_tol=3e-2)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_with_cache_prefill_then_decode(per_row, window):
    """Prefill into an empty cache (the kernel's site), then decode steps
    (full-matrix attention over the cache), f32 model over float32 caches
    (bf16 caches: tests/test_torch_lm.py)."""
    jcfg, tcfg = _cfgs("qwen3-0.6b", "float32")
    rng = np.random.default_rng(5)
    jp, tp = _attn_params(jcfg, rng, "float32")
    B, T, S = 2, 12, 24
    jc = JL.init_cache(jcfg, B, S, jnp.float32, per_row=per_row)
    tc = TL.init_cache(tcfg, B, S, torch.float32, per_row=per_row)
    x = rng.standard_normal((B, T, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jy, jc = JL.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                          window=window, cache=jc)
    ty, tc = TL.attention(tcfg, tp, torch.from_numpy(x),
                          torch.from_numpy(pos).long(), window=window,
                          cache=tc, from_start=True)
    _close(ty, jy)
    _close(tc["k"], jc["k"])
    assert tc["idx"] == int(jc["idx"])
    for i in range(4):
        x = rng.standard_normal((B, 1, jcfg.d_model), np.float32)
        p = np.array([[T + i], [T + i]], np.int32)
        jy, jc = JL.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(p),
                              window=window, cache=jc)
        ty, tc = TL.attention(tcfg, tp, torch.from_numpy(x),
                              torch.from_numpy(p).long(), window=window,
                              cache=tc)
        _close(ty, jy)
    _close(tc["v"], jc["v"])


def test_per_row_cache_writes_only_live_rows():
    _, tcfg = _cfgs("qwen3-0.6b", "float32")
    rng = np.random.default_rng(6)
    _, tp = _attn_params(tcfg, rng, "float32")
    tc = TL.init_cache(tcfg, 3, 8, torch.float32, per_row=True)
    x = torch.from_numpy(rng.standard_normal((3, 1, tcfg.d_model),
                                             np.float32))
    pos = torch.tensor([[2], [5], [1]])
    _, tc = TL.attention(tcfg, tp, x, pos, cache=dict(tc,
                                                      rows=torch.tensor([0, 2])))
    written = tc["k"].abs().sum(dim=(2, 3)) > 0
    assert written.tolist() == [[False, False, True] + [False] * 5,
                                [False] * 8,
                                [False, True] + [False] * 6]


def test_contiguous_cache_overflow_raises():
    _, tcfg = _cfgs("qwen3-0.6b", "float32")
    _, tp = _attn_params(tcfg, np.random.default_rng(7), "float32")
    tc = TL.init_cache(tcfg, 1, 4, torch.float32)
    x = torch.zeros(1, 5, tcfg.d_model)
    with pytest.raises(ValueError, match="cache overflow"):
        TL.attention(tcfg, tp, x, torch.arange(5)[None], cache=tc,
                     from_start=True)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(mlp_type, dtype):
    jcfg, tcfg = _cfgs("qwen3-0.6b", dtype, mlp_type=mlp_type)
    rng = np.random.default_rng(8)
    names = {"swiglu": ("wg", "wu", "wd"), "geglu": ("wg", "wu", "wd"),
             "gelu": ("wu", "bu", "wd", "bd")}[mlp_type]
    shapes = {"wg": (64, 128), "wu": (64, 128), "wd": (128, 64),
              "bu": (128,), "bd": (64,)}
    p = {n: rng.standard_normal(shapes[n], np.float32) * 0.2 for n in names}
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    x = rng.standard_normal((2, 5, 64), np.float32)
    jx, tx = _pair(x, dtype)
    _close(TL.mlp(tcfg, tp, tx), JL.mlp(jcfg, jp, jx), dtype)


def test_init_shapes_and_dtypes_follow_jax():
    for arch in ("qwen3-0.6b", "qwen2-0.5b", "olmo-1b"):
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfgs(arch, dtype)
            ja = jax.eval_shape(lambda: JL.init_attention(
                jcfg, jax.random.PRNGKey(0)))
            ta = TL.init_attention(tcfg, torch.Generator().manual_seed(0))
            assert sorted(ja) == sorted(ta)
            for k in ja:
                assert tuple(ja[k].shape) == tuple(ta[k].shape), k
                assert str(ja[k].dtype) == str(ta[k].dtype).split(".")[-1]
            jm = jax.eval_shape(lambda: JL.init_mlp(jcfg,
                                                    jax.random.PRNGKey(0)))
            tm = TL.init_mlp(tcfg, torch.Generator().manual_seed(0))
            assert {k: tuple(v.shape) for k, v in jm.items()} == \
                {k: tuple(v.shape) for k, v in tm.items()}
            jn = JL.init_norm(jcfg, 64)
            tn = TL.init_norm(tcfg, 64)
            assert sorted(jn) == sorted(tn)
            jc = JL.init_cache(jcfg, 2, 8, per_row=True)
            tc = TL.init_cache(tcfg, 2, 8, per_row=True)
            assert tuple(jc["k"].shape) == tuple(tc["k"].shape)
            assert tc["k"].dtype == torch.bfloat16 and tc["per_row"]
