"""Kernel 4's chunked route on the CPU (``csrc/wkv.cu``,
``wkv_chunk_kernel``: chunks of 64 steps, the inter-chunk, state and
off-diagonal intra-chunk products on wgmma with float32 operands split
into bf16 high and low parts, the diagonal 16 x 16 blocks on the CUDA
cores), run under the sm90 emulator (tests/sm90/emu.h: the warpgroup's
threads at barriers, cp.async, wgmma computed from its descriptors and the
fragment layouts of sm90.cuh), as tests/test_torch_rglru_sm90.py does for
kernel 5.

Held to the plain version ``wkv_ref`` at chip_smoke.py phase 13's
tolerances (``WKV_TOL``: y bf16 1e-2, S_final 1e-4, each of max(1,
max |ref|)): T of 1, a chunk - 1, a chunk, a chunk + 1, 200 and 2,048;
S0 zero and given; decays exp(-exp(x)) for x from -8 to 3, where a
log-space ratio of cumulative decays would overflow float32; 32 and 64
columns a block; w in float32 and bf16; the model's [B, T, H, 64]
layout read through ``transpose(1, 2)`` views, also with heads sliced out
of a wider tensor.  The step route (``wkv_kernel``) runs on the same
emulator at its own tolerances; the wrapper's choice of route
(``wkv_plan``) is checked on CPU tensors.  The kernels run on the card in
tests/test_torch_gpu.py and chip_smoke.py phase 13.
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import wkv_ref

from torch_parity import build_wkv_host, wkv_host_call

wrapper = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")

CHUNK = 64
# chip_smoke.py WKV_TOL (phase 13)
TOL = {"y_bfloat16": 1e-2, "y_float32": 1e-4, "S": 1e-4}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    fn = build_wkv_host(tmp_path_factory.mktemp("wkv_sm90"))
    if fn is None:
        pytest.skip("needs g++ (C++20) to build the emulator")
    return fn


def _inputs(seed, B, H, T, dtype=torch.bfloat16, wdtype=torch.float32,
            with_s0=False, x_range=(-8.0, 3.0), extra_heads=0):
    """r, k, v ~ 0.5 N(0, 1), w = exp(-exp(x)) with x uniform over
    ``x_range``, u ~ 0.5 N(0, 1), S0 ~ 0.2 N(0, 1), from numpy, as
    [B, H, T, 64] views of the model's [B, T, H, 64] (with
    ``extra_heads``, of a [B, T, H + extra_heads, 64] tensor)."""
    rng = np.random.default_rng(seed)
    Hw = H + extra_heads

    def view(x, dt):
        return torch.from_numpy(x.astype(np.float32)).to(dt)[:, :, :H] \
            .transpose(1, 2)

    r, k, v = (view(rng.standard_normal((B, T, Hw, 64)) * 0.5, dtype)
               for _ in range(3))
    w = view(np.exp(-np.exp(rng.uniform(*x_range, (B, T, Hw, 64)))), wdtype)
    u = torch.from_numpy((rng.standard_normal((H, 64)) * 0.5)
                         .astype(np.float32))
    S0 = (torch.from_numpy((rng.standard_normal((B, H, 64, 64)) * 0.2)
                           .astype(np.float32)) if with_s0 else None)
    return r, k, v, w, u, S0


def _errors(got, want):
    (y, S), (yr, Sr) = got, want
    ey = float((y.float() - yr.float()).abs().max()) / max(
        1.0, float(yr.float().abs().max()))
    eS = float((S - Sr).abs().max()) / max(1.0, float(Sr.abs().max()))
    return ey, eS


CASES = [
    # B, H, T, columns a block, S0
    (1, 1, 1, 64, True),          # decode's shape, one partial chunk
    (2, 1, CHUNK - 1, 32, False),
    (1, 2, CHUNK, 32, True),
    (2, 1, CHUNK + 1, 64, True),  # a chunk and one step
    (1, 2, 200, 32, False),
    (1, 1, 2048, 64, True),       # 32 chunks: the state carried through
]


@pytest.mark.parametrize("B,H,T,nj,with_s0", CASES)
def test_chunked_route_holds_phase13_tolerances(host, B, H, T, nj, with_s0):
    args = _inputs(T + nj, B, H, T, with_s0=with_s0)
    got = wkv_host_call(host, *args, route=1, nj=nj)
    ey, eS = _errors(got, wkv_ref(*args))
    assert ey <= TOL["y_bfloat16"] and eS <= TOL["S"], (ey, eS)
    assert got[0].dtype == torch.bfloat16


@pytest.mark.parametrize("x_range", [(-8.0, -8.0), (3.0, 3.0), (-8.0, 3.0)])
def test_chunked_route_at_extreme_decays(host, x_range):
    """Decays of exp(-exp(-8)) (~1 - 3e-4: the long memory), exp(-exp(3))
    (~2e-9: products underflow to 0 within a sub-chunk) and both mixed;
    no ratio of cumulative decays, so nothing overflows."""
    args = _inputs(7, 1, 2, 150, with_s0=True, x_range=x_range)
    got = wkv_host_call(host, *args, route=1, nj=32)
    assert all(torch.isfinite(x).all() for x in got)
    ey, eS = _errors(got, wkv_ref(*args))
    assert ey <= TOL["y_bfloat16"] and eS <= TOL["S"], (x_range, ey, eS)


@pytest.mark.parametrize("nj", [32, 64])
def test_chunked_route_bf16_decay_and_sliced_heads(host, nj):
    """w in bf16 (the other instantiation) and heads 1..3 of a 5-head
    tensor: time stride 5 x 64, head stride 64, read in place."""
    args = _inputs(nj, 2, 3, 130, wdtype=torch.bfloat16, with_s0=True,
                   x_range=(-6.0, 1.0), extra_heads=2)
    assert args[0].stride() == (130 * 5 * 64, 64, 5 * 64, 1)
    got = wkv_host_call(host, *args, route=1, nj=nj)
    ey, eS = _errors(got, wkv_ref(*args))
    assert ey <= TOL["y_bfloat16"] and eS <= TOL["S"], (ey, eS)


@pytest.mark.parametrize("dtype,T", [(torch.float32, 40),
                                     (torch.bfloat16, 1)])
def test_step_route(host, dtype, T):
    """The step kernel (float32, and decode's T = 1) on the same emulator:
    y within 1e-4 (float32) / 1e-2 (bf16), S within 1e-4."""
    args = _inputs(3, 2, 2, T, dtype=dtype, with_s0=True, x_range=(-6, 0))
    got = wkv_host_call(host, *args, route=0)
    ey, eS = _errors(got, wkv_ref(*args))
    name = "y_float32" if dtype == torch.float32 else "y_bfloat16"
    assert ey <= TOL[name] and eS <= TOL["S"], (ey, eS)


def test_wkv_plan():
    """The wrapper's route: chunked for bf16 r, k, v with T of a chunk or
    more and 16-byte aligned rows, else the step kernel; 64 columns a
    block when B x H blocks fill the card, else 32."""
    def x(B, T, H, dtype=torch.bfloat16):
        return torch.zeros(B, T, H, 64, dtype=dtype).transpose(1, 2)

    def plan(B, T, H, dtype=torch.bfloat16, wdtype=torch.float32, n=132):
        r = x(B, T, H, dtype)
        return wrapper.wkv_plan(r, r, r, x(B, T, H, wdtype),
                                torch.empty_like(r), n)

    assert plan(8, 2048, 64) == ("chunk", 64)
    assert plan(1, 2048, 64) == ("chunk", 32)
    assert plan(1, 2048, 32) == ("chunk", 32)
    assert plan(2, 2048, 64) == ("chunk", 64)
    assert plan(8, 2048, 64, wdtype=torch.bfloat16) == ("chunk", 64)
    assert plan(8, 1, 64) == ("step", 64)                     # decode
    assert plan(8, CHUNK - 1, 64) == ("step", 64)
    assert plan(8, CHUNK, 64)[0] == "chunk"
    assert plan(8, 2048, 64, dtype=torch.float32) == ("step", 64)
    # a row start off 16 bytes: one element into the storage
    base = torch.zeros(1 + 2 * 100 * 4 * 64, dtype=torch.bfloat16)
    r = base[1:].view(2, 100, 4, 64).transpose(1, 2)
    w = x(2, 100, 4, torch.float32)
    assert wrapper.wkv_plan(r, r, r, w, torch.empty_like(r), 132) == \
        ("step", 64)


def test_source_geometry_and_build_names():
    """The chunk and its sub-chunks are the ones these tests assume; every
    column width leaves room for two blocks an SM."""
    src = (build.CSRC / "wkv.cu").read_text()
    assert f"constexpr int kL = {CHUNK};" in src
    assert "constexpr int kSub = 16;" in src
    assert wrapper.CHUNK == CHUNK
    assert build.SOURCE_FLAGS["wkv.cu"] == build._BASE_FLAGS
    for nj, wbytes in itertools.product((32, 64), (4, 2)):
        assert 2 * (wrapper.chunk_smem_bytes(nj, wbytes) + 1024) <= 233_472
        assert wrapper.chunk_smem_bytes(nj, wbytes) <= 232_448
    assert build.wkv_instance(
        "_ZN12_GLOBAL__N_116wkv_chunk_kernelIfLi64EEEvPK13__nv_bfloat16S3_"
        "S3_PKT_PKfSA_PS1_Pfii7StridesSE_SE_SE_SE_") == \
        ("chunk", "bfloat16", "float32", 64)
    assert build.wkv_instance(
        "_ZN12_GLOBAL__N_116wkv_chunk_kernelI13__nv_bfloat16Li32EEEvPKS1_"
        ) == ("chunk", "bfloat16", "bfloat16", 32)
