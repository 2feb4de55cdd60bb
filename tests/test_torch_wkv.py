"""The port's WKV recurrence on the CPU against the JAX package's: the plain
version (``wkv_ref``, kernel 4's) and the ``ops`` wrapper, which on CPU
tensors computes the plain version, held to JAX's Pallas kernel in
interpret mode, to its oracle and to the model's ``wkv_scan_with_state``
from a non-zero state.

Shapes are tests/test_kernels.py:66-108's.  Inputs are drawn with numpy
and rounded to bf16 the same way on both sides.  Tolerances: float32
2e-5 (tests/test_kernels.py), both sides summing the same float32 products
in another order; bf16 inputs 2e-2 of the largest |y| (the output is
rounded once to bf16, a relative 2^-8, and a last-bit float32 difference
can flip that rounding).  The CUDA kernel is held to the plain version on
the card (tests/test_torch_gpu.py, chip_smoke.py phase 13).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import wkv as j_wkv
from repro.kernels.rwkv6 import wkv_oracle as j_wkv_oracle
from repro.models.rwkv6 import wkv_scan_with_state as j_scan_with_state
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import (wkv, wkv_bhtd, wkv_bwd_bhtd,
                                       wkv_bwd_ref, wkv_oracle, wkv_ref)

def _inputs(seed, B, T, H, dtype, w_dtype=None):
    """r, k, v, w [B, T, H, 64] and u [H, 64] as (jax, torch) lists; w in
    ``w_dtype`` (default: ``dtype``)."""
    rng = np.random.default_rng(seed)
    hd = 64
    xs = [rng.standard_normal((B, T, H, hd), dtype=np.float32) * 0.5
          for _ in range(3)]
    xs.append((1.0 / (1.0 + np.exp(-rng.standard_normal(
        (B, T, H, hd), dtype=np.float32))) * 0.5 + 0.45).astype(np.float32))
    xs.append(rng.standard_normal((H, hd), dtype=np.float32) * 0.3)
    dts = [dtype] * 3 + [w_dtype or dtype, "float32"]
    jx = [jnp.asarray(x).astype(getattr(jnp, d)) for x, d in zip(xs, dts)]
    tx = [torch.from_numpy(x).to(getattr(torch, d)) for x, d in zip(xs, dts)]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, dtype):
    a, b = _np(a), _np(b)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-2 * float(np.abs(b).max()))


@pytest.mark.parametrize("B,T,H", [(1, 64, 1), (2, 96, 2), (1, 256, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_matches_jax_kernel_and_oracle(B, T, H, dtype):
    jx, tx = _inputs(T, B, T, H, dtype)
    y, S = wkv(*tx)
    assert y.dtype == tx[0].dtype and S.dtype == torch.float32
    assert tuple(S.shape) == (B, H, 64, 64)
    _close(y, j_wkv(*jx, bt=32, interpret=True), dtype)
    _close(y, j_wkv_oracle(*jx), dtype)
    assert torch.equal(wkv_oracle(*tx), y)


@pytest.mark.parametrize("dtype,w_dtype", [("float32", "float32"),
                                           ("bfloat16", "float32")])
def test_wkv_from_a_state_matches_the_models_scan(dtype, w_dtype):
    """y and S_final from a non-zero S0 equal JAX's wkv_scan_with_state, in
    the model's dtypes (r/k/v in the activation type, w float32)."""
    B, T, H = 2, 40, 2
    jx, tx = _inputs(5, B, T, H, dtype, w_dtype)
    S0 = np.random.default_rng(6).standard_normal(
        (B, H, 64, 64), dtype=np.float32) * 0.2
    jy, jS = j_scan_with_state(*jx, jnp.asarray(S0))
    y, S = wkv(*tx, torch.from_numpy(S0))
    _close(y, jy, dtype)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), atol=2e-5,
                               rtol=2e-5)
    # a prefill split in two carries the state exactly
    y1, S1 = wkv(*[x[:, :17] for x in tx[:4]], tx[4], torch.from_numpy(S0))
    y2, S2 = wkv(*[x[:, 17:] for x in tx[:4]], tx[4], S1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(S2, S)


def test_kernel_layout_is_a_strided_view_and_the_state_is_optional():
    _, tx = _inputs(1, 2, 24, 3, "float32")
    r, k, v, w, u = tx
    y, S = wkv_bhtd(*[x.transpose(1, 2) for x in (r, k, v, w)], u)
    y0, S0 = wkv_bhtd(*[x.transpose(1, 2) for x in (r, k, v, w)], u,
                      torch.zeros(2, 3, 64, 64))
    assert torch.equal(y, y0) and torch.equal(S, S0)
    assert torch.equal(y.transpose(1, 2), wkv(r, k, v, w, u)[0])
    # one step of decode is the recurrence's step
    yt, St = wkv_ref(*[x[:, :1].transpose(1, 2) for x in (r, k, v, w)], u,
                     S0)
    assert tuple(yt.shape) == (2, 3, 1, 64) and tuple(St.shape) == \
        (2, 3, 64, 64)


def test_executors_autograd_and_no_fallback_on_the_cpu():
    _, tx = _inputs(2, 1, 8, 2, "float32")
    before, bwd0 = wkv_bhtd.launches, wkv_bwd_bhtd.launches
    a = wkv(*tx, executor="auto")
    b = wkv(*tx, executor="reference")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert wkv_bhtd.launches == before   # CPU: no launch
    with pytest.raises(ValueError, match="executor='cuda' needs CUDA"):
        wkv(*tx, executor="cuda")
    with pytest.raises(ValueError, match="unknown attention executor"):
        wkv(*tx, executor="pallas")
    # under autograd: the WKV Function, whose gradients equal the plain
    # pair's (wkv_ref, wkv_bwd_ref) under either executor, with no launch
    grad = [x.clone().requires_grad_() for x in tx]
    y, S = wkv(*grad)
    assert type(y.grad_fn).__name__ == "TransposeBackward0"
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(y, grad, dy)
    ref = torch.autograd.grad(wkv(*grad, executor="reference")[0], grad, dy)
    want = wkv_bwd_ref(*[x.detach().transpose(1, 2) for x in tx[:4]],
                       tx[4], None, dy.transpose(1, 2))
    for a, b, c in zip(got, ref, want):
        assert torch.equal(a, b)
        assert torch.equal(a, c.transpose(1, 2) if c.dim() == 4 else c)
    assert wkv_bhtd.launches == before and wkv_bwd_bhtd.launches == bwd0
    with torch.no_grad():
        assert not wkv(*grad)[0].requires_grad


def test_wrapper_checks_shapes_and_dtypes():
    x = torch.zeros(1, 2, 4, 64)
    u = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="shapes differ"):
        wkv_bhtd(x, x, x, torch.zeros(1, 2, 5, 64), u)
    with pytest.raises(ValueError, match=r"u \(3, 64\)"):
        wkv_bhtd(x, x, x, x, torch.zeros(3, 64))
    with pytest.raises(ValueError, match="S0"):
        wkv_bhtd(x, x, x, x, u, torch.zeros(1, 2, 64, 32))
    with pytest.raises(ValueError, match="dtypes differ"):
        wkv_bhtd(x, x.bfloat16(), x, x, u)


def test_build_flags_and_instances():
    assert build.SOURCE_FLAGS["wkv.cu"] == build._BASE_FLAGS
    names = {"_ZN12_GLOBAL__N_110wkv_kernelIffEEvPKT_S3_S3_PKT0_":
             ("step", "float32", "float32", 64),
             "_ZN12_GLOBAL__N_110wkv_kernelI13__nv_bfloat16fEEvPKT_":
             ("step", "bfloat16", "float32", 64),
             "_ZN12_GLOBAL__N_110wkv_kernelI13__nv_bfloat16S1_EEvPKT_":
             ("step", "bfloat16", "bfloat16", 64),
             "_ZN12_GLOBAL__N_116wkv_chunk_kernelIfLi32EEEvPK13__nv_bfloat16":
             ("chunk", "bfloat16", "float32", 32)}
    for name, inst in names.items():
        assert build.wkv_instance(name) == inst
    assert build.wkv_instance("rglru_kernelIfE") is None
