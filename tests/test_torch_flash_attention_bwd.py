"""The port's flash-attention backward on the CPU against the JAX
package's: the plain version (``attention_bwd_ref``), the wrapper (which on
CPU tensors computes the plain version) and the ``FlashAttention`` autograd
Function, held to JAX's ``flash_attention_trainable`` (its Pallas dq and
dk/dv kernels in interpret mode) and to ``jax.vjp`` through JAX's oracle.

Head widths 64 and 128 (the dense family's) and 256 (recurrentgemma-2b's
local MQA, 10/1 heads).  Tolerance 5e-5 (float32), as
tests/test_kernels.py:181-182 holds JAX's backward kernels to its oracle.  Inputs are drawn with numpy.  The CUDA
kernels themselves are held to the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_trainable
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bhtd,
                                                 flash_attention_bwd_bhtd,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as bwd_module

TOL = 5e-5


def _inputs(seed, B, T, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    shapes = [(B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd), (B, T, H, hd)]
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _t(x):
    return x.transpose(1, 2)


def _port_grads(q, k, v, do, causal, window):
    """(o, dq, dk, dv) of the port in the model layout: the Function via
    ``ops.flash_attention`` under autograd."""
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    return [x.detach().numpy() for x in (o, *grads)]


def _plain_grads(q, k, v, do, causal, window):
    """(o, dq, dk, dv) from the plain versions called directly."""
    tq, tk, tv, tdo = [_t(torch.from_numpy(x)) for x in (q, k, v, do)]
    o, lse = attention_ref(tq, tk, tv, causal=causal, window=window,
                           return_lse=True)
    grads = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                              window=window)
    return [_t(x).numpy() for x in (o, *grads)]


def _jax_vjp(fn, q, k, v, do):
    o, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in (q, k, v)])
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


def _jax_oracle(causal, window):
    def fn(q, k, v):
        def tr(a):
            return a.transpose(0, 2, 1, 3)
        return tr(j_attention_ref(tr(q), tr(k), tr(v), causal=causal,
                                  window=window))
    return fn


def _close(got, want, names=("o", "dq", "dk", "dv")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("B,T,H,Hkv,causal,window", [
    (1, 256, 4, 2, True, 0),
    (2, 128, 4, 4, False, 0),
    (1, 256, 4, 1, True, 64),
    (1, 384, 6, 2, True, 0),
])
def test_backward_matches_jax_trainable_kernels(B, T, H, Hkv, causal,
                                                window):
    """tests/test_kernels.py's four backward cases (hd 64): the port's
    Function and plain version against JAX's Pallas dq / dk-dv kernels run
    in interpret mode."""
    q, k, v, do = _inputs(B * T + H, B, T, H, Hkv, 64)
    want = _jax_vjp(lambda q, k, v: flash_attention_trainable(
        q, k, v, causal, window, True), q, k, v, do)
    _close(_port_grads(q, k, v, do, causal, window), want)
    _close(_plain_grads(q, k, v, do, causal, window), want)


@pytest.mark.parametrize("T,H,Hkv,hd,causal,window", [
    (200, 4, 2, 64, True, 0),      # ragged: T not a multiple of any tile
    (200, 4, 1, 128, True, 48),    # ragged, hd 128, window
    (256, 16, 8, 128, True, 0),    # qwen3's heads
    (256, 14, 2, 64, False, 0),    # qwen2's heads, non-causal
    (130, 10, 1, 256, True, 0),    # recurrentgemma's heads (MQA, hd 256)
    (130, 10, 1, 256, True, 64),   # ... with the sliding window
    (256, 10, 1, 256, True, 0),
])
def test_backward_matches_jax_autodiff_of_the_oracle(T, H, Hkv, hd, causal,
                                                     window):
    q, k, v, do = _inputs(T + hd, 2, T, H, Hkv, hd)
    want = _jax_vjp(_jax_oracle(causal, window), q, k, v, do)
    _close(_port_grads(q, k, v, do, causal, window), want)
    _close(_plain_grads(q, k, v, do, causal, window), want)


@pytest.mark.parametrize("window", [0, 64])
def test_backward_at_recurrentgemma_heads_matches_jax_kernels(window):
    """recurrentgemma-2b's local attention (10 query heads, 1 key/value
    head of 256), causal: the Function and the plain version against JAX's
    Pallas kernels in interpret mode."""
    q, k, v, do = _inputs(256 + window, 1, 256, 10, 1, 256)
    want = _jax_vjp(jax.jit(lambda q, k, v: flash_attention_trainable(
        q, k, v, True, window, True)), q, k, v, do)
    _close(_port_grads(q, k, v, do, True, window), want)
    _close(_plain_grads(q, k, v, do, True, window), want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_function_matches_torch_autograd_of_the_plain_version(causal,
                                                              window):
    """The Function (forward with LSE, backward from it) against PyTorch's
    own autograd through ``attention_ref``; also with ``reference``."""
    q, k, v, do = _inputs(11, 2, 128, 4, 2, 64)
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want = [o.detach().numpy()] + [x.numpy() for x in torch.autograd.grad(
        o, (tq, tk, tv), torch.from_numpy(do))]
    _close(_port_grads(q, k, v, do, causal, window), want)
    o = flash_attention(tq, tk, tv, causal=causal, window=window,
                        executor="reference")
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    got = [o.detach().numpy()] + [x.numpy() for x in torch.autograd.grad(
        o, (tq, tk, tv), torch.from_numpy(do))]
    _close(got, want)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v, do = [_t(torch.from_numpy(x)) for x in
                   _inputs(5, 1, 96, 4, 2, 64)]
    o, lse = flash_attention_bhtd(q, k, v, return_lse=True)
    before = flash_attention_bwd_bhtd.launches
    got = flash_attention_bwd_bhtd(q, k, v, o, lse, do)
    want = attention_bwd_ref(q, k, v, o, lse, do)
    assert flash_attention_bwd_bhtd.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [tuple(x.shape) for x in got] == [(1, 4, 96, 64),
                                            (1, 2, 96, 64), (1, 2, 96, 64)]


def test_executor_cuda_on_cpu_tensors_raises_under_autograd():
    q, k, v = [torch.from_numpy(x).requires_grad_() for x in
               _inputs(2, 1, 64, 4, 2, 64)[:3]]
    with pytest.raises(ValueError, match="executor='cuda' needs CUDA"):
        flash_attention(q, k, v, executor="cuda")


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = [_t(torch.from_numpy(x)) for x in
                   _inputs(3, 1, 64, 4, 2, 64)]
    o, lse = flash_attention_bhtd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd_bhtd(q, k, v, o, lse[..., :-1], do)
    with pytest.raises(ValueError, match="does not match q"):
        flash_attention_bwd_bhtd(q, k, v, o, lse, do.double())
    with pytest.raises(ValueError, match="divisor count"):
        flash_attention_bwd_bhtd(q, k[:, :1].expand(1, 3, 64, 64),
                                 v[:, :1].expand(1, 3, 64, 64), o, lse, do)


def test_backward_source_flags_instances_and_shared_memory():
    """The backward source has its own flags (no fast math), its own
    instance parser for the build report, and shared-memory sizes that
    match the source's formulas."""
    from repro_torch.kernels import build

    assert "flash_attention_bwd.cu" in build.SOURCE_FLAGS
    assert "--use_fast_math" not in build.SOURCE_FLAGS[
        "flash_attention_bwd.cu"]
    names = {
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_"
        "PS1_iiiiNS_7StridesEiif": ("dq", "float32", 64),
        "_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li128EEEv"
        "PKT_S4_S4_S4_PKfS6_PS2_S7_iiiiNS_7StridesEiif":
            ("dkdv", "bfloat16", 128)}
    for name, inst in names.items():
        assert build.flash_attention_bwd_instance(name) == inst
        assert build.flash_attention_instance(name) is None
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for const in ("kQBQ = 64", "kQBK = 32", "kKBK = 32", "kKBQ = 64"):
        assert f"constexpr int {const};" in src
    dq, dkdv = bwd_module.smem_bytes(128)
    assert (dq, dkdv) == (107_520, 116_224)
    # hd 256 (recurrentgemma): the same formulas, under the opt-in limit
    assert bwd_module.smem_bytes(256) == (205_824, 214_528)
    assert 256 in bwd_module.HEAD_DIMS and "if (hd == 256)" in src
    assert all(b <= 232_448 for hd in bwd_module.HEAD_DIMS
               for b in bwd_module.smem_bytes(hd))
