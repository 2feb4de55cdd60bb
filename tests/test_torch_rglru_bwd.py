"""The RG-LRU scan's backward on the CPU: ``RGLRUScan`` (the autograd
Function ``kernels/rglru.rglru`` runs under autograd: kernel 5 forward, the
backward kernel's reverse scan) through its plain versions against
``jax.vjp`` of the JAX package's associative scan and of its model's
``rg_lru``; ``gradcheck`` of the plain pair in float64; and
``csrc/rglru.cu``'s two kernels built by g++ for the host
(tests/tick_host/rglru_harness.cpp on the sm90 emulator), bit-equal to the
plain versions.

Tolerances, float32, as a share of each gradient's largest magnitude:
the scan's gradients 2e-6 (measured 1.9e-7), the model's rg_lru
gradients (block-diagonal gates, decay, the sqrt gate, h0 folded into
b_0) 1e-5 (measured 9.2e-7).  JAX differentiates its associative scan,
whose tree sums in another order than the sequential reverse recurrence
(ROADMAP queue 3), and the gate and decay gradients sum the scan's over B
and T.  The host build: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.rglru import rglru_oracle as j_oracle
from repro.models import rglru as JR
from repro_torch import convert
from repro_torch.kernels import build
from repro_torch.kernels.rglru import (RGLRUScan, rglru, rglru_bwd_ref,
                                       rglru_ref, rglru_scan,
                                       rglru_scan_bwd)
from repro_torch.models import rglru as TR
from repro_torch.tree import leaves_with_paths

from torch_parity import build_rglru_host, rglru_host_call

SCAN_TOL = 2e-6
MODEL_TOL = 1e-5


def _inputs(seed, B, T, C):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, C), np.float32)))
         * 0.4 + 0.5).astype(np.float32)
    b = rng.standard_normal((B, T, C), np.float32) * 0.1
    g = rng.standard_normal((B, T, C), np.float32)
    return a, b, g


def _close(got, want, tol, name):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (name, err)


@pytest.mark.parametrize("C", [64, 640])
@pytest.mark.parametrize("T", [1, 96, 256])
def test_scan_gradients_match_jax_vjp(T, C):
    a, b, g = _inputs(T + C, 2, T, C)
    want = [np.asarray(x) for x in jax.jit(
        lambda a, b, g: jax.vjp(j_oracle, a, b)[1](g))(a, b, g)]
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    h = rglru(ta, tb)
    assert type(h.grad_fn).__name__ == "RGLRUScanBackward"
    got = torch.autograd.grad(h, (ta, tb), torch.from_numpy(g))
    for x, w, name in zip(got, want, ("da", "db")):
        assert x.dtype == torch.float32 and x.shape == ta.shape
        _close(x.numpy(), w, SCAN_TOL, name)
    # the Function is its plain versions on the CPU, under either executor
    ref = torch.autograd.grad(rglru(ta, tb, executor="reference"), (ta, tb),
                              torch.from_numpy(g))
    assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_plain_pair_passes_gradcheck_in_float64():
    a, b, _ = _inputs(5, 2, 11, 7)
    ta, tb = (torch.from_numpy(x).double().requires_grad_() for x in (a, b))
    assert torch.autograd.gradcheck(
        lambda a, b: RGLRUScan.apply(a, b, True), (ta, tb), eps=1e-6,
        atol=1e-7, rtol=1e-6)


def test_backward_is_the_reverse_recurrence():
    """db_{T-1} = g_{T-1}, db_t = a_{t+1} db_{t+1} + g_t with the product
    rounded first, da_t = db_t h_{t-1} and da_0 = 0 (h_{-1} = 0)."""
    a, b, g = (torch.from_numpy(x) for x in _inputs(9, 2, 30, 50))
    h = rglru_ref(a, b)
    da, db = rglru_bwd_ref(a, h, g)
    assert torch.equal(db[:, -1], g[:, -1])
    for t in (0, 13, 28):
        assert torch.equal(db[:, t], a[:, t + 1] * db[:, t + 1] + g[:, t])
        if t:
            assert torch.equal(da[:, t], db[:, t] * h[:, t - 1])
    assert not da[:, 0].any()


@pytest.mark.parametrize("with_h0", [False, True])
def test_model_rg_lru_gradients_match_jax(with_h0):
    """The model's rg_lru under autograd (RGLRUScan inside) against
    ``jax.vjp`` of JAX's, on converted weights: gradients of x, every
    parameter of the block and h0."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              dtype="float32")
    p = JR.init_recurrent_block(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, cfg.lru_width), np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width), np.float32)
    gy = rng.standard_normal(x.shape, np.float32)
    gh = rng.standard_normal(h0.shape, np.float32)

    def jfn(p, x, h0):
        return JR.rg_lru(p, x, h0 if with_h0 else None)
    jp, jx, jh0 = jax.jit(lambda p, x, h0, gy, gh: jax.vjp(jfn, p, x, h0)[1](
        (gy, gh)))(p, x, h0, gy, gh)

    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, p), cfg, "cpu")
    leaves = [v.requires_grad_() for _, v in leaves_with_paths(tp)]
    tx, th0 = (torch.from_numpy(v).requires_grad_() for v in (x, h0))
    y, hl = TR.rg_lru(tp, tx, th0 if with_h0 else None)
    grads = torch.autograd.grad((y, hl), leaves + [tx, th0],
                                (torch.from_numpy(gy), torch.from_numpy(gh)),
                                allow_unused=True)
    want = [np.asarray(v) for _, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    names = [n for n, _ in leaves_with_paths(tp)]
    for name, gt, w in zip(names + ["x", "h0"], grads, want + [jx, jh0]):
        w = np.asarray(w)
        if gt is None:
            assert not w.any(), name
            continue
        _close(gt.numpy(), w, MODEL_TOL, name)
    assert (grads[-1] is not None) == with_h0


def test_cpu_wrappers_launch_nothing_and_check_inputs():
    a, b, g = (torch.from_numpy(x) for x in _inputs(2, 1, 8, 64))
    before = rglru_scan_bwd.launches
    h = rglru_scan(a, b)
    got = rglru_scan_bwd(a, h, g)
    assert all(torch.equal(x, y) for x, y in zip(got, rglru_bwd_ref(a, h,
                                                                    g)))
    assert rglru_scan_bwd.launches == before
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_bwd(a, h, g[:, :4])
    with pytest.raises(ValueError, match="differ in dtype"):
        rglru_scan_bwd(a, h, g.double())


def test_build_instances():
    assert build.rglru_bwd_instance(
        "_ZN12_GLOBAL__N_116rglru_bwd_kernelIfLi32EEEv14CUtensorMap_stS1_S1_"
        "S1_S1_PKT_S4_S4_PfS5_iixxxxxxxxxxi") == ("float32", 32)
    assert build.rglru_bwd_instance(
        "_ZN12_GLOBAL__N_116rglru_bwd_kernelI13__nv_bfloat16Li16EEEv14CUtens"
        "orMap_st") == ("bfloat16", 16)
    assert build.rglru_instance(
        "_ZN12_GLOBAL__N_116rglru_bwd_kernelIfLi32EEEv14CUtensorMap_st") is \
        None
    assert build.rglru_bwd_instance(
        "_ZN12_GLOBAL__N_112rglru_kernelIfLi32EEEv14CUtensorMap_stS1_PKT_"
        "S4_PS2_iixxxxxxi") is None
    # the first backward (one thread a channel, no width) is gone
    assert build.rglru_bwd_instance(
        "_ZN12_GLOBAL__N_116rglru_bwd_kernelIfEEvPKT_S3_S3_PfS4_iixxxxxxxxxx"
    ) is None


# ------------------------------------------------------- the host build --

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    fn = build_rglru_host(tmp_path_factory.mktemp("rglru_host"))
    if fn is None:
        pytest.skip("needs g++ to build rglru.cu for the host")
    return fn


def _host(fn, bwd, xs, outs):
    rglru_host_call(fn, int(bwd), xs, outs)


@pytest.mark.parametrize("B,T,C", [(2, 37, 300), (1, 1, 128), (3, 64, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_build_equals_plain_versions(host_lib, B, T, C, dtype):
    """Forward (its direct path) and backward kernel, ragged T (not a
    multiple of the unrolled 8) and C (not of the forward's 32-channel or
    the backward's 128-thread block), bit for bit; the backward reads a
    strided g.  tests/test_torch_rglru_sm90.py runs the forward's TMA
    ring."""
    a, b, g = (torch.from_numpy(x).to(dtype) for x in _inputs(T, B, T, C))
    h = torch.empty_like(a)
    _host(host_lib, 0, (a, b), (h,))
    assert torch.equal(h, rglru_ref(a, b))
    gs = torch.cat([g, g], dim=2)[..., :C]    # channel stride 1, time 2 C
    assert gs.stride() == (2 * T * C, 2 * C, 1)
    da, db = (torch.full((B, T, C), float("nan")) for _ in range(2))
    _host(host_lib, 1, (a, h, gs), (da, db))
    want = rglru_bwd_ref(a, h, gs)
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])
