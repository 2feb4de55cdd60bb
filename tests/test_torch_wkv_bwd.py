"""The WKV recurrence's backward on the CPU: the plain version
(``wkv_bwd_ref``) against ``jax.vjp`` of the JAX model's scans
(``wkv_scan`` from zero, ``wkv_scan_with_state`` from S0) with cotangents
on y and on S_final; ``gradcheck`` of the plain pair in float64; the
``WKV`` autograd Function (forward kernel 4, backward ``wkv_bwd_bhtd``)
under the executors, launching nothing on the CPU; the chunked route's
algebra in float64 (``torch_parity.wkv_bwd_chunked_f64``) against the
step form; the routing (``wkv_bwd_plan``); and both routes' kernels
(``csrc/wkv_bwd.cu``, ``csrc/wkv_bwd_chunk.cu``) built by g++ for the host
(tests/sm90/wkv_bwd_harness.cpp on the sm90 emulator) against the plain
version.

Inputs are drawn with numpy; decays are exp(-exp(x)) for x uniform in
[-8, 3] (x = 3: ~2e-9, where a walk back by dividing by w would blow up).
Tolerances, as a share of each gradient's largest |value|: float32 1e-5
(measured ~4e-7: both sides sum the same float32 products in other
orders); bf16 r, k, v (w float32, the model's pair) 2e-2: dr, dk, dv are
rounded once to bf16 (2^-8 relative), and a last-bit float32 difference
can flip that rounding; the host build 1e-5 in float32 and 1e-2 for its
bf16 outputs (measured 1.5e-3; the chunked route's float32 outputs 4e-6,
its operands split bf16 high + low as kernel 4's chunked route splits
them, so it is held to 1e-4 as the card holds it); the chunked algebra in
float64 1e-12 (measured 1.5e-15).  The kernels are held to the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py phase 22).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_scan as j_scan
from repro.models.rwkv6 import wkv_scan_with_state as j_scan_with_state
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import (WKV, wkv, wkv_bhtd, wkv_bwd_bhtd,
                                       wkv_bwd_ref)
from repro_torch.kernels.rwkv6 import rwkv6 as wrapper

from torch_parity import (build_wkv_bwd_host, wkv_bwd_chunk_host_call,
                          wkv_bwd_chunked_f64, wkv_bwd_host_call)

F32_TOL = 1e-5
BF16_TOL = 2e-2
HOST_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
CHUNK_HOST_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
F64_TOL = 1e-12
NAMES = ("dr", "dk", "dv", "dw", "du", "dS0")


def _draw(seed, B, T, H, x_range=(-8.0, 3.0)):
    """r, k, v, w [B, T, H, 64], u [H, 64], S0 [B, H, 64, 64] and the
    cotangents dy [B, T, H, 64], dS [B, H, 64, 64], float32 numpy; decays
    exp(-exp(x)), x uniform over ``x_range``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, 64), np.float32) * 0.5
               for _ in range(3))
    x = rng.uniform(*x_range, (B, T, H, 64))
    w = np.exp(-np.exp(x)).astype(np.float32)
    u = rng.standard_normal((H, 64), np.float32) * 0.5
    S0 = rng.standard_normal((B, H, 64, 64), np.float32) * 0.2
    dy = rng.standard_normal((B, T, H, 64), np.float32)
    dS = rng.standard_normal((B, H, 64, 64), np.float32) * 0.1
    return r, k, v, w, u, S0, dy, dS


def _bhtd(x, dtype=torch.float32):
    """[B, T, H, 64] numpy -> the kernels' [B, H, T, 64] view."""
    return torch.from_numpy(x).to(dtype).transpose(1, 2)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_grads(r, k, v, w, u, S0, dy, dS, with_s0, dtype="float32"):
    """JAX's (dr, dk, dv, dw, du[, dS0]) in the model layout."""
    cast = getattr(jnp, dtype)
    xs = [jnp.asarray(x).astype(cast) for x in (r, k, v)]
    xs += [jnp.asarray(w), jnp.asarray(u)]
    gy = jnp.asarray(dy).astype(cast)
    if with_s0:
        fn = jax.jit(lambda *a: jax.vjp(j_scan_with_state, *a[:6])[1](a[6:]))
        return fn(*xs, jnp.asarray(S0), gy, jnp.asarray(dS))
    fn = jax.jit(lambda *a: jax.vjp(j_scan, *a[:5])[1](a[5:]))
    return fn(*xs, gy, jnp.asarray(dS))


def _port_grads(r, k, v, w, u, S0, dy, dS, with_s0, dtype=torch.float32):
    """wkv_bwd_ref's gradients, dr .. dw back in the model layout."""
    got = wkv_bwd_ref(_bhtd(r, dtype), _bhtd(k, dtype), _bhtd(v, dtype),
                      _bhtd(w), torch.from_numpy(u),
                      torch.from_numpy(S0) if with_s0 else None,
                      _bhtd(dy, dtype), torch.from_numpy(dS))
    return [x.transpose(1, 2) if i < 4 else x for i, x in enumerate(got)]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("B,H", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_plain_backward_matches_jax_vjp(B, H, T, with_s0):
    xs = _draw(T + 10 * B + H, B, T, H)
    want = _jax_grads(*xs, with_s0)
    got = _port_grads(*xs, with_s0)
    assert got[0].dtype == got[3].dtype == torch.float32
    assert tuple(got[4].shape) == (H, 64)
    for name, g, j in zip(NAMES, got, want):
        assert _rel(g.numpy(), j) <= F32_TOL, name
    if not with_s0:   # dS0 of a zero start: the cotangent walked to t = 0
        assert tuple(got[5].shape) == (B, H, 64, 64)


@pytest.mark.parametrize("T", [64, 200])
def test_bf16_inputs_match_jax_vjp(T):
    """r, k, v and dy in bf16, w float32 (the model's pair): each side
    rounds dr, dk, dv to bf16 once; dw, du, dS0 stay float32."""
    xs = _draw(T, 2, T, 2)
    want = _jax_grads(*xs, True, "bfloat16")
    got = _port_grads(*xs, True, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + \
        [torch.float32] * 3
    for name, g, j in zip(NAMES, got, want):
        assert _rel(g.float().numpy(), np.asarray(j, np.float32)) <= \
            BF16_TOL, name


def test_plain_pair_passes_gradcheck_in_float64():
    r, k, v, w, u, S0, _, _ = _draw(5, 1, 3, 1)
    args = [_bhtd(x, torch.float64).requires_grad_() for x in (r, k, v, w)]
    args += [torch.from_numpy(x).double().requires_grad_() for x in (u, S0)]
    assert torch.autograd.gradcheck(
        lambda *a: WKV.apply(*a, True), args, eps=1e-6, atol=1e-7,
        rtol=1e-6)


@pytest.mark.parametrize("executor", ["auto", "reference"])
def test_function_backward_is_the_plain_version(executor):
    """wkv under autograd in the model layout, y and S_final both in the
    loss: the gradients are wkv_bwd_ref's on the same inputs, bit for bit,
    and nothing launches on the CPU."""
    r, k, v, w, u, S0, dy, dS = _draw(7, 2, 70, 2)
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (r, k, v, w, u, S0)]
    before = (wkv_bhtd.launches, wkv_bwd_bhtd.launches)
    y, S = wkv(*leaves, executor=executor)
    assert type(y.grad_fn).__name__ == "TransposeBackward0"
    got = torch.autograd.grad((y, S), leaves,
                              (torch.from_numpy(dy), torch.from_numpy(dS)))
    want = _port_grads(r, k, v, w, u, S0, dy, dS, True)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name
    assert (wkv_bhtd.launches, wkv_bwd_bhtd.launches) == before
    # y alone in the loss: S_final's gradient arrives as None (zeros)
    y, _ = wkv(*leaves, executor=executor)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = wkv_bwd_ref(*[_bhtd(x) for x in (r, k, v, w)],
                       torch.from_numpy(u), torch.from_numpy(S0),
                       _bhtd(dy))
    assert torch.equal(got[0], want[0].transpose(1, 2))
    assert torch.equal(got[5], want[5])


def test_function_takes_a_cpu_executor_and_no_fallback():
    r, k, v, w, u, _, _, _ = _draw(2, 1, 8, 2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    with pytest.raises(ValueError, match="executor='cuda' needs CUDA"):
        wkv(*leaves, executor="cuda")
    y, S = wkv(*leaves)
    assert y.requires_grad and S.requires_grad
    r0 = leaves[0].detach()
    with torch.no_grad():
        assert torch.equal(wkv(*leaves)[0], y.detach())
    # the wrapper holds dy and dS_final to r's shape, dtype and device
    args = [x.transpose(1, 2) for x in (r0, r0, r0, r0)]
    u0 = leaves[4].detach()
    with pytest.raises(ValueError, match="dy"):
        wkv_bwd_bhtd(*args, u0, None, args[0][:, :, :4])
    with pytest.raises(ValueError, match="dy"):
        wkv_bwd_bhtd(*args, u0, None, args[0].double())
    with pytest.raises(ValueError, match="dS_final"):
        wkv_bwd_bhtd(*args, u0, None, args[0], torch.zeros(1, 2, 64, 32))


@pytest.mark.parametrize("x_range", [(-8.0, 3.0), (-8.0, -8.0), (3.0, 3.0)])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("T", [64, 65, 128, 200])
def test_chunked_algebra_in_float64_is_the_step_form(T, with_s0, x_range):
    """The chunked route's algebra (state pass, then per chunk the
    products, scans and sub-chunk sums of csrc/wkv_bwd_chunk.cu) in
    float64 equals the step form: whole chunks, a one-step and a ragged
    last chunk; S0 and dS_final given or zero; decays over [-8, 3], at
    x = -8 (1 - 3e-4: the long memory) and x = 3 (2e-9: products
    underflow within a sub-chunk)."""
    r, k, v, w, u, S0, dy, dS = (torch.from_numpy(x).double() for x in
                                 _draw(T + int(with_s0), 1, T, 2, x_range))
    args = [x.transpose(1, 2) for x in (r, k, v, w)] + [u]
    args += [S0 if with_s0 else None, dy.transpose(1, 2),
             dS if with_s0 else None]
    want = wkv_bwd_ref(*args)
    got = wkv_bwd_chunked_f64(*args)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= F64_TOL * float(
            b.abs().max()), name


def test_wkv_bwd_plan():
    """The backward's route by wkv_plan's rule: chunked for bf16 r, k, v
    with T of a chunk or more and 16-byte aligned rows (the state pass over
    64 columns a block when B x H blocks fill the card, else 32), else the
    step kernel; the trainer's call (bf16, w float32, B 2 x T 4,096 x H
    64) takes the chunked route."""
    def x(B, T, H, dtype=torch.bfloat16):
        return torch.zeros(B, T, H, 64, dtype=dtype).transpose(1, 2)

    def plan(B, T, H, dtype=torch.bfloat16, wdtype=torch.float32, n=132):
        r = x(B, T, H, dtype)
        got = wrapper.wkv_bwd_plan(r, r, r, x(B, T, H, wdtype), r, n)
        assert got == wrapper.wkv_plan(r, r, r, x(B, T, H, wdtype), r, n)
        return got

    assert plan(2, 4096, 64) == ("chunk", 64)
    assert plan(1, 2048, 64) == ("chunk", 32)
    assert plan(2, 4096, 64, wdtype=torch.bfloat16) == ("chunk", 64)
    assert plan(2, wrapper.CHUNK, 64)[0] == "chunk"
    assert plan(2, wrapper.CHUNK - 1, 64) == ("step", 64)
    assert plan(1, 200, 4, dtype=torch.float32) == ("step", 64)
    # a row start off 16 bytes: one element into the storage
    base = torch.zeros(1 + 2 * 100 * 4 * 64, dtype=torch.bfloat16)
    r = base[1:].view(2, 100, 4, 64).transpose(1, 2)
    assert wrapper.wkv_bwd_plan(r, r, r, x(2, 100, 4, torch.float32),
                                x(2, 100, 4), 132) == ("step", 64)


def test_chunked_route_geometry():
    """The chunk and sub-chunk the algebra assumes; a state-pass block
    leaves room for two an SM, a chunk-pass block (two warpgroups) fits one
    (232,448 bytes a block at most, 233,472 an SM, 1 KB each reserved)."""
    src = (build.CSRC / "wkv_bwd_chunk.cu").read_text()
    assert f"constexpr int kL = {wrapper.CHUNK};" in src
    assert "constexpr int kSub = 16;" in src
    assert build.SOURCE_FLAGS["wkv_bwd_chunk.cu"] == build._BASE_FLAGS
    for w_bytes in (4, 2):
        assert wrapper.bwd_chunk_smem_bytes(w_bytes) <= 232_448
        for nj in (32, 64):
            assert 2 * (wrapper.bwd_state_smem_bytes(nj, w_bytes) + 1024) \
                <= 233_472
    n_state, n_du = wrapper.wkv_bwd_chunk_scratch_floats(2, 64, 4096)
    assert n_state == 2 * 64 * 64 * 64 * 64 and n_du == 2 * 64 * 64 * 64


def test_build_flags_and_instances():
    assert build.SOURCE_FLAGS["wkv_bwd.cu"] == build._BASE_FLAGS
    names = {"_ZN12_GLOBAL__N_114wkv_bwd_kernelIffEEvNS_4ArgsIT_T0_EE":
             ("float32", "float32"),
             "_ZN12_GLOBAL__N_114wkv_bwd_kernelI13__nv_bfloat16fEEvNS_4Args":
             ("bfloat16", "float32"),
             "_ZN12_GLOBAL__N_114wkv_bwd_kernelI13__nv_bfloat16S1_EEvNS_4A":
             ("bfloat16", "bfloat16")}
    for name, inst in names.items():
        assert build.wkv_bwd_instance(name) == inst
    assert build.wkv_bwd_instance(
        "_ZN12_GLOBAL__N_110wkv_kernelIffEEvPKT_S3_S3_PKT0_") is None
    assert build.wkv_instance(next(iter(names))) is None
    # the chunked route's entries (nvcc's names, as ptxas reports them)
    prefix = "_ZN49_GLOBAL__N__26da44b0_16_wkv_bwd_chunk_cu_92ed1109"
    chunked = {
        "20wkv_bwd_state_kernelIfLi64EEEvNS_4ArgsIT_EE":
            ("bfloat16", "float32", "state/64"),
        "20wkv_bwd_state_kernelI13__nv_bfloat16Li32EEEvNS_4ArgsIT_EE":
            ("bfloat16", "bfloat16", "state/32"),
        "20wkv_bwd_chunk_kernelIfEEvNS_4ArgsIT_EE":
            ("bfloat16", "float32", "chunk"),
        "20wkv_bwd_chunk_kernelI13__nv_bfloat16EEvNS_4ArgsIT_EE":
            ("bfloat16", "bfloat16", "chunk")}
    for name, inst in chunked.items():
        assert build.wkv_bwd_instance(prefix + name) == inst
        assert build.wkv_instance(prefix + name) is None


# ------------------------------------------------------- the host build --

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    fn = build_wkv_bwd_host(tmp_path_factory.mktemp("wkv_bwd_host"))
    if fn is None:
        pytest.skip("needs g++ to build wkv_bwd.cu for the host")
    return fn


@pytest.mark.parametrize("B,H,T,dtype,w_dtype,with_s0,with_ds", [
    (1, 2, 0, torch.float32, torch.float32, True, True),
    (1, 2, 1, torch.float32, torch.float32, False, False),
    (1, 1, 65, torch.float32, torch.float32, True, True),
    (1, 1, 72, torch.bfloat16, torch.bfloat16, False, True),
    (1, 1, 129, torch.bfloat16, torch.float32, True, False)])
def test_host_build_equals_plain_version(host_lib, B, H, T, dtype, w_dtype,
                                         with_s0, with_ds):
    """No step (T 0: dS0 is dS_final, du 0), one checkpoint (T 1), two
    (T 65: a one-step last chunk), a ragged last sub-chunk (T 72), three
    chunks (T 129); heads sliced out of a wider tensor (every stride
    differs from a contiguous one); both type pairs."""
    r, k, v, w, u, S0, dy, dS = _draw(T, B, T, 2 * H)

    def heads(x, dt):
        return _bhtd(x, dt)[:, H:]          # the upper H of 2 H heads

    args = [heads(x, dtype) for x in (r, k, v)] + [heads(w, w_dtype)]
    u_t = torch.from_numpy(u[H:])
    S0_t = torch.from_numpy(S0[:, H:]) if with_s0 else None
    dS_t = torch.from_numpy(dS[:, H:]) if with_ds else None
    g = heads(dy, dtype)
    got = wkv_bwd_host_call(host_lib, *args, u_t, S0_t, g, dS_t)
    want = wkv_bwd_ref(*args, u_t, S0_t, g, dS_t)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a.float().numpy(), b.float().numpy()) <= \
            HOST_TOL[a.dtype], name


@pytest.mark.parametrize("H,T,w_dtype,with_s0,with_ds,nj,x_range", [
    (1, 64, torch.float32, True, True, 32, (-8.0, 3.0)),
    (2, 65, torch.float32, False, False, 64, (-8.0, 3.0)),
    (1, 128, torch.bfloat16, True, True, 32, (-8.0, -8.0)),
    (1, 200, torch.float32, True, False, 32, (3.0, 3.0)),
    (2, 200, torch.bfloat16, False, True, 64, (-8.0, 3.0))])
def test_host_chunked_route_equals_plain_version(host_lib, H, T, w_dtype,
                                                 with_s0, with_ds, nj,
                                                 x_range):
    """The chunked route (state pass over 32 or 64 columns a block, then
    the chunk pass) on bf16 r, k, v, dy: one chunk, a one-step last chunk
    (T 65), whole chunks, a ragged last chunk (T 200); heads sliced out of
    a wider tensor; w float32 or bf16; decays over [-8, 3] and at x = -8
    and x = 3."""
    B = 1
    r, k, v, w, u, S0, dy, dS = _draw(T + 7 * H, B, T, 2 * H, x_range)

    def heads(x, dt):
        return _bhtd(x, dt)[:, H:]          # the upper H of 2 H heads

    args = [heads(x, torch.bfloat16) for x in (r, k, v)] + [
        heads(w, w_dtype)]
    u_t = torch.from_numpy(u[H:])
    S0_t = torch.from_numpy(S0[:, H:]) if with_s0 else None
    dS_t = torch.from_numpy(dS[:, H:]) if with_ds else None
    g = heads(dy, torch.bfloat16)
    got = wkv_bwd_chunk_host_call(host_lib, *args, u_t, S0_t, g, dS_t,
                                  nj=nj)
    want = wkv_bwd_ref(*args, u_t, S0_t, g, dS_t)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a.float().numpy(), b.float().numpy()) <= \
            CHUNK_HOST_TOL[a.dtype], name
