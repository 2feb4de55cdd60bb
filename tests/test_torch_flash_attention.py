"""The port's flash attention on the CPU against the JAX package's: the
plain version (``attention_ref`` / ``flash_attention_ref``) and the ``ops``
wrapper, which on CPU tensors computes the plain version, held to JAX's
Pallas kernel in interpret mode and to its oracle.

Sweeps and tolerances are tests/test_kernels.py's (float32 2e-5, bf16
2e-2).  Inputs are drawn with numpy and rounded to bf16 the same way on both
sides.  The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 7).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_fa
from repro.kernels.flash_attention import flash_attention_ref as j_fa_ref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bhtd as j_fa_bhtd
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhtd,
                                                 flash_attention_ref)

# the kernel's module (the package re-exports ops.flash_attention under the
# module's name)
fa_module = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(x).astype(jd) for x in xs],
            [torch.from_numpy(x).to(td) for x in xs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,T,H,Hkv,hd", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA
    (1, 256, 8, 1, 128),     # MQA, wide head
    (2, 384, 6, 2, 64),      # non-power-of-two T
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep_matches_jax(B, T, H, Hkv, hd, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        B * 1000 + T + H, [(B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)],
        dtype)
    tol = TOLS[dtype]
    jo = j_fa(jq, jk, jv, causal=causal, bq=128, bk=128, interpret=True)
    jr = j_fa_ref(jq, jk, jv, causal=causal)
    to = flash_attention(tq, tk, tv, causal=causal)
    tr = flash_attention_ref(tq, tk, tv, causal=causal)
    assert to.dtype == tq.dtype and tuple(to.shape) == (B, T, H, hd)
    for got in (to, tr):
        np.testing.assert_allclose(_np(got), _np(jo), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(got), _np(jr), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_sliding_window_matches_jax(window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, [(2, 256, 4, 64), (2, 256, 1, 64), (2, 256, 1, 64)], "float32")
    jo = j_fa(jq, jk, jv, causal=True, window=window, interpret=True)
    to = flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np(flash_attention_ref(tq, tk, tv, causal=True, window=window)),
        _np(j_fa_ref(jq, jk, jv, causal=True, window=window)),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_lse_matches_jax_kernel(causal, window):
    """The log-sum-exp output the training slice's backward will read."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(2, 4, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64)], "float32")
    jo, jl = j_fa_bhtd(jq, jk, jv, causal=causal, window=window,
                       interpret=True, return_lse=True)
    to, tl = flash_attention_bhtd(tq, tk, tv, causal=causal, window=window,
                                  return_lse=True)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 4, 256)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-5, rtol=2e-5)


def test_kernel_layout_is_a_strided_view_of_the_model_layout():
    """[B,T,H,hd] goes to the wrapper as a transpose view: same result as
    a contiguous [B,H,T,hd] copy (on the card the output also keeps q's
    strides: tests/test_torch_gpu.py)."""
    _, (tq, tk, tv) = _inputs(
        5, [(2, 96, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64)], "float32")
    o = flash_attention_bhtd(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2))
    oc = flash_attention_bhtd(tq.transpose(1, 2).contiguous(),
                              tk.transpose(1, 2).contiguous(),
                              tv.transpose(1, 2).contiguous())
    assert torch.equal(o, oc)


def test_non_causal_partial_block_raises_as_in_jax():
    _, (tq, tk, tv) = _inputs(
        1, [(1, 200, 2, 64), (1, 200, 2, 64), (1, 200, 2, 64)], "float32")
    with pytest.raises(ValueError, match="divisible by bk"):
        flash_attention(tq, tk, tv, causal=False)
    with pytest.raises(ValueError, match="divisible by bk"):
        j_fa(*[jnp.asarray(x.numpy()) for x in (tq, tk, tv)], causal=False,
             interpret=True)


def test_executors_and_no_fallback_on_the_cpu():
    _, (tq, tk, tv) = _inputs(
        2, [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)], "float32")
    before = flash_attention_bhtd.launches
    a = flash_attention(tq, tk, tv, executor="auto")
    b = flash_attention(tq, tk, tv, executor="reference")
    assert torch.equal(a, b)
    assert flash_attention_bhtd.launches == before   # CPU: no launch
    with pytest.raises(ValueError, match="executor='cuda' needs CUDA"):
        flash_attention(tq, tk, tv, executor="cuda")
    with pytest.raises(ValueError, match="unknown attention executor"):
        flash_attention(tq, tk, tv, executor="pallas")


def test_wrapper_checks_shapes_and_layout():
    x = torch.zeros(1, 4, 64, 64)
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention_bhtd(x, x.double(), x)
    with pytest.raises(ValueError, match="divisor count"):
        flash_attention_bhtd(x, torch.zeros(1, 3, 64, 64),
                             torch.zeros(1, 3, 64, 64))
    with pytest.raises(ValueError, match="forward only"):
        flash_attention_bhtd(x.clone().requires_grad_(), x, x)
    # the kernel's layout rule: hd contiguous, 16-byte aligned strides
    fa_module._check_kernel_layout("q", x.transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_module._check_kernel_layout("q", torch.zeros(1, 4, 64, 65)[..., 1:])
    with pytest.raises(ValueError, match="contiguous last dimension"):
        fa_module._check_kernel_layout("q", x.transpose(2, 3))


def test_every_source_has_its_own_flags_and_no_fast_math():
    from repro_torch.kernels import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sorted(build.SOURCE_FLAGS) == sources
    for flags in build.SOURCE_FLAGS.values():
        assert "--use_fast_math" not in flags
        assert "arch=compute_90a,code=sm_90a" in flags
    # the tick loop's bit-exact flags stay its own
    assert "-fmad=false" not in build.SOURCE_FLAGS["flash_attention.cu"]
    assert build.SOURCE_FLAGS["tick_loop.cu"] == build.NVCC_FLAGS
    names = {"_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_"
             "Pfiiiixxxxxxxxxxxxiif": ("float32", 64),
             "_ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li128EEEv"
             "PKT_S4_S4_PS2_Pfiiiixxxxxxxxxxxxiif": ("bfloat16", 128)}
    for name, inst in names.items():
        assert build.flash_attention_instance(name) == inst
    assert build.flash_attention_instance("tick_loop_kernelILi3ELi1ELb1E") \
        is None
