"""Kernel 5's TMA pipeline on the CPU (``csrc/rglru.cu``, ``rglru_kernel``:
a and b streamed through a ring of shared-memory stages by 3-D TMA, h
written over a's tile and stored by TMA, one warp a block over 16 or 32
channels), run under the sm90 emulator (tests/sm90/emu.h: the block's
threads at barriers, the mbarriers' phases and transaction bytes,
unswizzled TMA loads with zeros past every bound, stores clipped to the
bounds), as tests/test_torch_flash_sm90.py does for kernels 2 and 3.

Held bit for bit to the plain version ``rglru_ref`` (x86-64 g++ contracts
no multiply-add, as the kernel's ``-fmad=false``) on both paths of the
kernel (the TMA ring, and the direct path it takes where TMA cannot address
the inputs), at both block widths and both dtypes, at shapes with T not a
multiple of the tile's steps, T = 1, C not a multiple of the block width,
a strided a, and enough tiles to wrap the ring; and the wrapper's choice
of path and width (``kernel_plan``) on the CPU.  The kernel runs on the
card in tests/test_torch_gpu.py and chip_smoke.py phases 14 and 19b.
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru import rglru_bwd_ref, rglru_ref

from torch_parity import build_rglru_host, rglru_host_call

# the module (the package's ``rglru`` is the autograd entry point)
rglru_wrapper = importlib.import_module("repro_torch.kernels.rglru.rglru")

TILE_BYTES = 8192
STAGES = 4


def tile_steps(dtype, width):
    """Steps of one stage's tile (csrc/rglru.cu ``Ring::kTc``)."""
    return TILE_BYTES // (width * torch.tensor([], dtype=dtype)
                          .element_size())


def bwd_tile_steps(width):
    """Steps of one stage's tile of the backward (csrc/rglru.cu
    ``BwdRing::kTc``: a float32 tile's, for either input type)."""
    return TILE_BYTES // (width * 4)


def bwd_stage_bytes(dtype, width):
    """Bytes of one stage of the backward's ring (``BwdRing::kStage``):
    a, h and g tiles; float32 da and db over h and g, or, for bf16, tiles
    of their own."""
    es = torch.tensor([], dtype=dtype).element_size()
    tin = bwd_tile_steps(width) * width * es
    return 3 * tin + (0 if es == 4 else 2 * TILE_BYTES)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    fn = build_rglru_host(tmp_path_factory.mktemp("rglru_sm90"))
    if fn is None:
        pytest.skip("needs g++ (C++20) to build the emulator")
    return fn


def _inputs(seed, B, T, C, dtype, strided=False):
    """a in (0.5, 0.9), b ~ 0.1 N(0, 1) from numpy, in ``dtype``; with
    ``strided`` a is a channel slice of a wider tensor (time stride C + 8,
    16-byte aligned) and b a view that starts inside a bigger storage."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 0.9, (B, T, C)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((B, T, C)) * 0.1)
                         .astype(np.float32))
    a, b = a.to(dtype), b.to(dtype)
    if strided:
        wide = torch.zeros(B, T, C + 8, dtype=dtype)
        wide[..., :C] = a
        a = wide[..., :C]
        b = torch.cat([b, b], dim=0)[B:]
        assert not a.is_contiguous()
    return a, b


def _scan(host, a, b, mode, width):
    h = torch.full(a.shape, float("nan"), dtype=a.dtype)
    rglru_host_call(host, mode, (a, b), (h,), width)
    return h


CASES = [
    # B, T, C
    (1, 1, 40),        # the decode step; C not a multiple of 16 or 32
    (2, 37, 64),       # T below one tile
    (1, 200, 100),     # T not a multiple of the tile; ragged C
    (2, 1100, 48),     # 5-18 tiles: the ring wraps several times
]


@pytest.mark.parametrize("B,T,C", CASES)
@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tma_ring_equals_plain_version(host, B, T, C, width, dtype):
    a, b = _inputs(T + C + width, B, T, C, dtype)
    want = rglru_ref(a, b)
    if T == 1100:
        assert T > STAGES * tile_steps(dtype, width)     # the ring wraps
    for mode in (2, 0):                  # the TMA ring, the direct path
        assert torch.equal(_scan(host, a, b, mode, width), want), mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_a_on_both_paths(host, dtype):
    """A channel slice of a wider tensor: TMA addresses it (aligned
    strides); b a view of a bigger storage."""
    B, T, C = 2, 300, 72
    a, b = _inputs(5, B, T, C, dtype, strided=True)
    assert a.stride() == (T * (C + 8), C + 8, 1)
    want = rglru_ref(a, b)
    for width in (16, 32):
        for mode in (2, 0):
            assert torch.equal(_scan(host, a, b, mode, width), want), \
                (width, mode)


def _bwd(host, a, h, g, mode, width):
    da, db = (torch.full(a.shape, float("nan")) for _ in range(2))
    rglru_host_call(host, mode, (a, h, g), (da, db), width)
    return da, db


BWD_CASES = [
    # B, T, C: T = 1; a tile - 1, a tile, a tile + 1 of either width's
    # float32 tile (64 or 128 steps); ragged T and C; the ring wrapping
    (1, 1, 40),
    (2, 63, 48),
    (1, 64, 32),
    (2, 65, 40),
    (1, 127, 64),
    (1, 128, 16),
    (2, 129, 36),
    (1, 200, 100),
    (2, 700, 48),
]


@pytest.mark.parametrize("B,T,C", BWD_CASES)
@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_ring_equals_plain_version(host, B, T, C, width, dtype):
    """The backward through its TMA ring (mode 3) and its direct path (mode
    1), bit for bit; the first tile's h box starts at time -1 (zero fill),
    a_{t+1} crosses every tile boundary in a register."""
    a, b = _inputs(3 * T + C + width, B, T, C, dtype)
    g = torch.from_numpy(np.random.default_rng(T + width).standard_normal(
        (B, T, C)).astype(np.float32)).to(dtype)
    h = rglru_ref(a, b)
    want = rglru_bwd_ref(a, h, g)
    if T == 700:
        assert T > STAGES * bwd_tile_steps(width)      # the ring wraps
    for mode in (3, 1):
        got = _bwd(host, a, h, g, mode, width)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_strided_g_on_both_paths(host, dtype):
    """g as the wrapper may meet it: a channel slice of a wider gradient
    (time stride 2 C, 16-byte aligned: TMA addresses it) and a, h views of
    bigger storages; both paths bit for bit."""
    B, T, C = 2, 150, 40
    a, b = _inputs(11, B, T, C, dtype, strided=True)
    h = rglru_ref(a, b)
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, T, 2 * C)).astype(np.float32)).to(dtype)[..., :C]
    assert g.stride() == (T * 2 * C, 2 * C, 1)
    want = rglru_bwd_ref(a, h, g)
    for width in (16, 32):
        for mode in (3, 1):
            got = _bwd(host, a, h, g, mode, width)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (width, mode)


def test_bwd_plan():
    """The backward's choice: the forward's width rule; TMA when it can
    address a, h, g, da and db (T > 1, 16-byte aligned bases and strides in
    each operand's own element size, rows that do not overlap)."""
    def plan(a, h, g, n_sms=132):
        da, db = (torch.empty(a.shape) for _ in range(2))
        return rglru_wrapper.bwd_plan(a, h, g, da, db, n_sms)

    def x(B, T, C, dtype=torch.float32):
        return torch.zeros(B, T, C, dtype=dtype)

    assert plan(*(x(2, 4096, 2560),) * 3) == (32, True)
    assert plan(*(x(1, 2048, 2560, torch.bfloat16),) * 3) == (16, True)
    assert plan(*(x(2, 1, 2560),) * 3) == (32, False)          # T = 1
    # the strided g of the card's test: time stride 2 C, aligned -> ring
    g = torch.zeros(2, 200, 600)[..., :300]
    assert plan(x(2, 200, 300), x(2, 200, 300), g) == (16, True)
    # bf16 C 300 -> 600-byte rows: a time stride TMA cannot take
    gb = torch.zeros(2, 200, 301, dtype=torch.bfloat16)[..., :300]
    assert plan(x(2, 200, 300, torch.bfloat16),
                x(2, 200, 300, torch.bfloat16), gb) == (16, False)
    # bf16 C 300 alone: 600-byte rows are not 16-byte multiples -> direct
    assert plan(*(x(2, 200, 300, torch.bfloat16),) * 3) == (16, False)


def test_kernel_plan():
    """The wrapper's choice: 32 channels a block when B x C / 32 blocks
    give every SM one, else 16; TMA when it can address a, b and h (T > 1,
    16-byte aligned base and strides, rows that do not overlap)."""
    def plan(a, b, n_sms=132):
        return rglru_wrapper.kernel_plan(a, b, torch.empty_like(a), n_sms)

    def x(B, T, C, dtype=torch.float32):
        return torch.zeros(B, T, C, dtype=dtype)

    assert plan(x(2, 4096, 2560), x(2, 4096, 2560)) == (32, True)
    assert plan(x(1, 2048, 2560), x(1, 2048, 2560)) == (16, True)
    assert plan(x(8, 2048, 2560), x(8, 2048, 2560)) == (32, True)
    assert plan(x(8, 1, 2560), x(8, 1, 2560)) == (32, False)
    # a time stride of 4 B x 2,561: not 16-byte aligned -> direct path
    odd = torch.zeros(2, 64, 2561)[..., :2560]
    assert plan(odd, x(2, 64, 2560)) == (32, False)
    # bf16 C 2,560: 5,120-byte rows; an offset of one element misaligns
    base = torch.zeros(2 * 64 * 2560 + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(2, 64, 2560)
    assert plan(shifted, x(2, 64, 2560, torch.bfloat16))[1] is False
    # broadcast rows overlap -> direct path
    bcast = torch.zeros(1, 1, 64).expand(2, 8, 64)
    assert plan(bcast, x(2, 8, 64)) == (16, False)
    # B = 1: the batch stride is never read, whatever it is
    one = torch.zeros(4, 64, 128)[:1]
    assert plan(one, x(1, 64, 128), 1) == (32, True)
    # an output TMA cannot address -> direct path
    a = x(2, 64, 2560)
    h_odd = torch.zeros(2, 64, 2561)[..., 1:]
    assert rglru_wrapper.kernel_plan(a, a, h_odd, 132) == (32, False)


def test_source_geometry_and_build_names():
    """The source's ring is the one these tests assume, fits a block's
    shared memory with room for two blocks an SM, and keeps -fmad=false."""
    src = (build.CSRC / "rglru.cu").read_text()
    assert f"constexpr int kTileBytes = {TILE_BYTES};" in src
    assert f"constexpr int kStages = {STAGES};" in src
    smem = 2 * STAGES * TILE_BYTES + 128
    assert 2 * smem <= 232_448
    for dtype, width, steps in ((torch.float32, 32, 64),
                                (torch.float32, 16, 128),
                                (torch.bfloat16, 32, 128),
                                (torch.bfloat16, 16, 256)):
        assert tile_steps(dtype, width) == steps <= 256   # a TMA box row
    assert "-fmad=false" in build.SOURCE_FLAGS["rglru.cu"]
    # the backward's ring: four stages a block, two blocks an SM
    for dtype, width in itertools.product((torch.float32, torch.bfloat16),
                                          (16, 32)):
        assert bwd_tile_steps(width) <= 256
        assert 2 * (STAGES * bwd_stage_bytes(dtype, width) + 128) <= 232_448
