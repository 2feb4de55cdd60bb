"""The port's RG-LRU scan on the CPU against the JAX package's: the plain
version (``rglru_ref``, kernel 5's sequential recurrence) and the ``ops``
wrapper, held to JAX's Pallas kernel in interpret mode and to its oracle
(``lax.associative_scan``), and the model's ``rg_lru`` (gates, decay, the
carried state folded into the first step) to JAX's.

Shapes are tests/test_kernels.py:110-147's.  Tolerances: float32 2e-5 and
bf16 2e-2 (tests/test_kernels.py): the associative scan's tree rounds
differently from the sequential recurrence (ROADMAP queue 3).  The CUDA
kernel equals the plain version bit for bit on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 14).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.rglru import rglru as j_rglru
from repro.kernels.rglru import rglru_oracle as j_oracle
from repro.models import rglru as JR
from repro_torch import convert
from repro_torch.kernels import build
from repro_torch.kernels.rglru import rglru, rglru_ref, rglru_scan
from repro_torch.models import rglru as TR

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, T, C, dtype):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, C), np.float32)))
         * 0.4 + 0.5).astype(np.float32)
    b = rng.standard_normal((B, T, C), np.float32) * 0.1
    return ([jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (a, b)],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b)])


@pytest.mark.parametrize("B,T,C", [(1, 64, 256), (2, 128, 512),
                                   (1, 96, 640)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_matches_jax_kernel_and_oracle(B, T, C, dtype):
    jx, tx = _inputs(C, B, T, C, dtype)
    h = rglru(*tx)
    assert h.dtype == tx[0].dtype and h.shape == tx[0].shape
    tol = TOLS[dtype]
    for want in (j_rglru(*jx, bt=32, bc=256, interpret=True),
                 j_oracle(*jx)):
        np.testing.assert_allclose(h.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_plain_version_is_the_sequential_recurrence():
    """Each step is a product rounded before the add, from zero: h_0 = b_0
    exactly, and a split scan continues exactly from its carry."""
    _, (a, b) = _inputs(3, 2, 40, 96, "float32")
    h = rglru_ref(a, b)
    assert torch.equal(h[:, 0], b[:, 0])
    for t in (1, 17, 39):
        assert torch.equal(h[:, t], a[:, t] * h[:, t - 1] + b[:, t])
    b2 = b[:, 17:].clone()
    b2[:, 0] = a[:, 17] * h[:, 16] + b[:, 17]
    assert torch.equal(rglru_ref(a[:, 17:], b2), h[:, 17:])


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_jax_model(with_h0):
    """The model's rg_lru (block-diagonal gates, decay, the sqrt gate, h0
    folded into b_0) against JAX's on converted weights."""
    cfg = get_smoke_config("recurrentgemma-2b")
    jcfg = dataclasses.replace(cfg, dtype="float32")
    p = JR.init_recurrent_block(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, p), jcfg,
                                    "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg.lru_width), np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width), np.float32) if with_h0 \
        else None
    jy, jh = jax.jit(JR.rg_lru)(p, jnp.asarray(x),
                       None if h0 is None else jnp.asarray(h0))
    y, h = TR.rg_lru(tp, torch.from_numpy(x),
                     None if h0 is None else torch.from_numpy(h0))
    assert h.dtype == torch.float32 and tuple(h.shape) == (2, cfg.lru_width)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-5,
                               rtol=2e-5)


def test_executors_autograd_and_no_fallback_on_the_cpu():
    _, tx = _inputs(2, 1, 8, 64, "float32")
    before = rglru_scan.launches
    assert torch.equal(rglru(*tx), rglru(*tx, executor="reference"))
    assert rglru_scan.launches == before   # CPU: no launch
    with pytest.raises(ValueError, match="executor='cuda' needs CUDA"):
        rglru(*tx, executor="cuda")
    with pytest.raises(ValueError, match="unknown attention executor"):
        rglru(*tx, executor="blocked")
    # under autograd: the RGLRUScan Function, its plain versions on the CPU
    a = tx[0].clone().requires_grad_()
    h = rglru(a, tx[1])
    assert type(h.grad_fn).__name__ == "RGLRUScanBackward"
    assert torch.equal(h.detach(), rglru_ref(*tx))
    assert rglru_scan.launches == before
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan(tx[0], tx[1][:, :4])
    with pytest.raises(ValueError, match="differ in dtype"):
        rglru_scan(tx[0], tx[1].bfloat16())


def test_build_flags_and_instances():
    """Kernel 5 is bit-exact: no contraction, IEEE subnormals (the plain
    version on the card does not flush them)."""
    flags = build.SOURCE_FLAGS["rglru.cu"]
    assert "-fmad=false" in flags and "-ftz=true" not in flags
    assert build.rglru_instance(
        "_ZN12_GLOBAL__N_112rglru_kernelIfLi32EEEv14CUtensorMap_stS1_PKT_"
        "S4_PS2_iixxxxxxi") == ("float32", 32)
    assert build.rglru_instance(
        "_ZN12_GLOBAL__N_112rglru_kernelI13__nv_bfloat16Li16EEEv14CUtensor"
        "Map_st") == ("bfloat16", 16)
    assert build.rglru_instance(
        "_ZN12_GLOBAL__N_112rglru_kernelIfEEvPKT_S3_PS1_iixxxxxx") is None
    assert build.rglru_instance("wkv_kernelIffE") is None
