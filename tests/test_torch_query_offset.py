"""A block of queries at an offset against every key (context-parallel
attention's query blocks): the plain versions of kernels 2 and 3
(``attention_ref``, ``attention_bwd_ref``) and the autograd Function on
the CPU with ``q_offset`` against JAX's ``attention_chunked(q_offset=...)``
and its ``jax.vjp``; ``kernels.cost``'s pair count with an offset against
a brute count.  The kernels themselves run with an offset under the sm90
emulator (tests/test_torch_flash_sm90.py, tests/test_torch_flash_f32_emu.py)
and on the card (chip_smoke.py phases 7 and 10).

Tolerances: float32 inputs, the plain versions' float32 sums against
XLA's in another order: 2e-5 (chip_smoke.py FLASH_TOL["float32"]) on the
output and 5e-5 + 5e-5 x |ref| (BWD_F32_TOL) on the gradients."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention_chunked as j_attention_chunked
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention)

FWD_TOL, BWD_TOL = 2e-5, 5e-5

#: (B, Tq, Tk, H, Hkv, hd, window, q_offset): the last of four blocks
#: (GQA 7, qwen2's grouping), a middle block whose last keys no query
#: reaches, a block with a window, and offset 0.
CASES = [
    (1, 32, 128, 7, 1, 16, 0, 96),
    (2, 24, 96, 4, 2, 8, 0, 24),
    (1, 40, 120, 2, 1, 16, 20, 60),
    (1, 48, 48, 4, 2, 8, 0, 0),
]


def _inputs(seed, B, Tq, Tk, H, Hkv, hd):
    """q, k, v, dO [B, T, heads, hd] float32 from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Tq, H, hd), (B, Tk, Hkv, hd), (B, Tk, Hkv, hd),
                      (B, Tq, H, hd))]


def _jax(q, k, v, do, window, q_offset):
    """JAX's o and (dq, dk, dv) of attention_chunked over the block."""
    def fn(q, k, v):
        return j_attention_chunked(q, k, v, causal=True, window=window,
                                   q_chunk=q.shape[1], q_offset=q_offset)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _hold(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        excess = float((np.abs(a - b) - BWD_TOL * np.abs(b)).max())
        assert excess <= BWD_TOL, excess


def _t(x):
    return torch.from_numpy(x).transpose(1, 2)


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd,window,q_offset", CASES)
def test_plain_versions_with_an_offset_match_jax(B, Tq, Tk, H, Hkv, hd,
                                                 window, q_offset):
    """attention_ref and attention_bwd_ref (kernel layout) at ``q_offset``
    against JAX's attention_chunked and its vjp; the keys no query
    reaches get zero gradients on both sides."""
    q, k, v, do = _inputs(Tq + Tk + q_offset, B, Tq, Tk, H, Hkv, hd)
    jo, jg = _jax(q, k, v, do, window, q_offset)
    o, lse = attention_ref(_t(q), _t(k), _t(v), window=window,
                           return_lse=True, q_offset=q_offset)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), jo, atol=FWD_TOL,
                               rtol=0)
    grads = attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                              window=window, q_offset=q_offset)
    got = [g.transpose(1, 2).numpy() for g in grads]
    _hold(got, jg)
    if q_offset + Tq < Tk:
        for g in got[1:]:
            assert not g[:, q_offset + Tq:].any()


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd,window,q_offset", CASES)
def test_autograd_function_with_an_offset_matches_jax(B, Tq, Tk, H, Hkv, hd,
                                                      window, q_offset):
    """ops.flash_attention(q_offset=...) under autograd on CPU tensors
    (the FlashAttention Function over the plain versions, as a
    context-parallel rank runs it): output and gradients against JAX."""
    q, k, v, do = _inputs(Tq + Tk + q_offset + 1, B, Tq, Tk, H, Hkv, hd)
    jo, jg = _jax(q, k, v, do, window, q_offset)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    y = flash_attention(*xs, window=window, q_offset=q_offset)
    np.testing.assert_allclose(y.detach().numpy(), jo, atol=FWD_TOL, rtol=0)
    got = torch.autograd.grad(y, xs, torch.from_numpy(do))
    _hold([g.numpy() for g in got], jg)


def test_causal_pairs_with_an_offset_is_the_brute_count():
    """cost.causal_pairs(Tq, Tk, causal, window, q_offset): the (query,
    key) pairs the masks leave, query row i at q_offset + i, counted one
    by one; without an offset it is the count the kernels' bounds used
    before (min(i + 1, reach) keys from query i)."""
    for Tq, Tk, w, off in itertools.product((1, 5, 16, 33), (1, 7, 16, 40),
                                            (0, 1, 3, 8, 50), (0, 2, 9, 30)):
        qpos = off + np.arange(Tq)[:, None]
        kpos = np.arange(Tk)[None, :]
        keep = kpos <= qpos
        if w > 0:
            keep &= kpos > qpos - w
        assert cost.causal_pairs(Tq, Tk, True, w, off) == int(keep.sum())
        assert cost.causal_pairs(Tq, Tk, False, w, off) == Tq * Tk
        if off == 0 and Tq <= Tk:
            r = min(Tk, w) if w > 0 else Tk
            assert cost.causal_pairs(Tq, Tk, True, w) == sum(
                min(i + 1, r) for i in range(Tq))
    # qwen2-0.5b train_4k at model 16: the last of 16 query blocks reaches
    # 0.121 of the whole sequence's pairs
    whole = cost.causal_pairs(4096, 4096, True)
    last = cost.causal_pairs(256, 4096, True, 0, 3840)
    assert (whole, last) == (8_390_656, 1_015_936)
    f, _ = cost.flash_fwd(1, 14, 2, 64, 256, 4096, True, 2, 0, 3840)
    assert f == 4 * 64 * 14 * last
