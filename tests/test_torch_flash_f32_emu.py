"""The float32 flash-attention kernels (``csrc/flash_attention.cu``, the
forward; ``csrc/flash_attention_bwd.cu``, the dq, dk/dv and share-sum
kernels: FMAs on register tiles, tiles brought in by cp.async) on the CPU.

* Their device code, cut before the launch functions, is built with g++
  against the Hopper emulator (tests/sm90/emu.h, with cp.async landing only
  when its thread waits for its group, so a ring stage read before its wait
  or its barrier reads garbage) and run with the launch functions' grids
  and block sizes (tests/sm90/flash_f32_harness.cpp).
* The forward is held to the JAX package's oracle
  (``repro.kernels.flash_attention.ref.attention_ref``) and its
  log-sum-exp within 2e-5 (chip_smoke.py phase 7's float32 tolerance); the
  backward, fed the emulated forward's o and lse, to ``jax.vjp`` of the
  oracle within 5e-5 + 5e-5 |ref| element-wise (phase 10's).  Inputs are
  drawn with numpy from a seed, as strided ``transpose(1, 2)`` views of
  [B, T, H, hd] (and a key/value view of a longer cache that holds NaN
  past Tk): hd 64, 128 and 256; GQA 1 and > 1; causal, window and
  non-causal; ragged T (partial query and key tiles).
* The shares that fill the card where blocks are few (``f32_split``,
  ``f32_dq_split``, ``f32_kv_split``) are combined in a fixed order: two
  runs are bit-equal, and one share and many agree.
* The shared-memory helpers follow the sources' layouts, and an H100 SM
  holds at least 8 warps of each kernel at hd 64 and 128 (and, as it
  happens, at 256, where 4 would do).

The kernels themselves run on the card in tests/test_torch_gpu.py and
chip_smoke.py phases 7, 10 and 19a.
"""
import ctypes
import functools
import importlib
import math
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models.layers import attention_chunked as j_attention_chunked
from repro_torch.kernels import build

fa = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
fb = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention_bwd")

EMULATOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sm90")
# The dk/dv shares are planned for a card of EMU_SMS SMs, so that the
# emulated cases (a few tiles each) have 2-8 shares, not the H100's dozens.
EMU_SMS = 4
FWD_TOL = 2e-5   # chip_smoke.py FLASH_TOL["float32"]
BWD_TOL = 5e-5   # chip_smoke.py BWD_F32_TOL (atol and rtol)
SMEM_LIMIT = 232_448


def _cut(source, namespace):
    """The device code of ``source`` (up to its launch function), in its
    own namespace, for g++."""
    s = (build.CSRC / source).read_text()
    s = s[:s.index("template <typename T, int HD>\nint launch(")]
    s = re.sub(r'#include [<"].*[>"]\n', "", s)
    s = s.replace("extern __shared__ uint8_t smem_raw[];", "using ::smem_raw;")
    return f"namespace {namespace} {{\n{s}\n}}}}\n"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulator")
    d = tmp_path_factory.mktemp("f32emu")
    (d / "flash_f32_cut.inc").write_text(
        _cut("flash_attention.cu", "fwdk")
        + _cut("flash_attention_bwd.cu", "bwdk"))
    so = d / "flash_f32_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-fvisibility=hidden", "-fno-gnu-unique", "-shared",
                    "-fPIC", "-pthread", f"-I{EMULATOR}", f"-I{build.CSRC}",
                    f"-I{d}", "-o", str(so),
                    os.path.join(EMULATOR, "flash_f32_harness.cpp")],
                   check=True, capture_output=True, timeout=600)
    h = ctypes.CDLL(str(so))
    ll = ctypes.POINTER(ctypes.c_longlong)
    h.flash_f32_fwd_host.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ll, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_int])
    h.flash_f32_bwd_host.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ll, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int, ctypes.c_void_p] * 2 + [ctypes.c_int])
    return h


def _strides(*xs):
    vals = [x.stride(i) for x in xs for i in (0, 1, 2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _scratch(split, *shape):
    """A share scratch of NaN (every element the kernels read is written
    first), or None for one share."""
    return torch.full((split, *shape), float("nan")) if split > 1 else None


def _ptr(x):
    return None if x is None else x.data_ptr()


def emulated_forward(lib, q, k, v, causal, window, split=None, q_offset=0):
    """(o, lse) of the float32 forward kernel under the emulator, o with
    q's strides as the wrapper allocates it; ``split`` shares (default: the
    wrapper's plan for a card of EMU_SMS SMs); query row i at position
    q_offset + i."""
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    if split is None:
        split = fa.f32_split(B, H, Tq, Tk, hd, EMU_SMS, causal, q_offset)
    o = torch.full_like(q, float("nan"))
    lse = torch.full((B, H, Tq), float("nan"))
    part = _scratch(split, B * H * Tq * (hd + 2))
    err = lib.flash_f32_fwd_host(
        hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, k.shape[1], Tq, Tk, _strides(q, k, v, o),
        int(causal), window, 1.0 / math.sqrt(hd), split, _ptr(part),
        q_offset)
    assert err == 0
    return o, lse


def emulated_backward(lib, q, k, v, o, lse, do, causal, window, split=None,
                      dq_split=None, q_offset=0):
    """(dq, dk, dv) of the float32 backward kernels under the emulator, with
    the wrapper's delta and ``split`` dk/dv and ``dq_split`` dq shares
    (default: the wrapper's plans for a card of EMU_SMS SMs)."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if split is None:
        split = fb.f32_kv_split(B, H, Hkv, Tq, Tk, hd, EMU_SMS)
    if dq_split is None:
        dq_split = fb.f32_dq_split(B, H, Tq, Tk, hd, EMU_SMS, causal,
                                   q_offset)
    delta = (do * o).sum(-1).contiguous()
    outs = [torch.full_like(x, float("nan")) for x in (q, k, v)]
    part = _scratch(2 * split, B, Hkv, Tk, hd)
    dq_part = _scratch(dq_split, B, H, Tq, hd)
    err = lib.flash_f32_bwd_host(
        hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.contiguous().data_ptr(), delta.data_ptr(),
        *[x.data_ptr() for x in outs], B, H, Hkv, Tq, Tk,
        _strides(q, k, v, do, *outs), int(causal), window,
        1.0 / math.sqrt(hd), split, _ptr(part), dq_split, _ptr(dq_part),
        q_offset)
    assert err == 0
    return outs


def _inputs(seed, shapes):
    """numpy draws (float32) as torch tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in shapes]


def _tr(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_forward(q, k, v, causal, window):
    """JAX's o [B, T, H, hd] and log-sum-exp [B, H, T] of the same scores
    (masked to -1e30 as the oracle masks them), one jitted call."""
    o = _tr(j_attention_ref(_tr(q), _tr(k), _tr(v), causal=causal,
                            window=window))
    hd, H, Hkv = q.shape[3], q.shape[2], k.shape[2]
    kr = jnp.repeat(_tr(k), H // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", _tr(q), kr) / math.sqrt(hd)
    Tq, Tk = q.shape[1], k.shape[1]
    qpos, kpos = jnp.arange(Tq)[:, None], jnp.arange(Tk)[None, :]
    mask = jnp.zeros((Tq, Tk), bool)
    if causal:
        mask |= kpos > qpos
    if window > 0:
        mask |= kpos <= qpos - window
    s = jnp.where(mask, -1.0e30, s)
    return o, jax.nn.logsumexp(s, axis=-1)


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd,causal,window,extra", [
    (1, 200, 200, 4, 2, 64, True, 0, 0),      # ragged T, GQA 2
    (1, 70, 130, 2, 2, 128, True, 0, 0),      # Tq != Tk
    (1, 150, 150, 3, 1, 128, False, 0, 0),    # non-causal, GQA 3
    (1, 200, 200, 2, 1, 256, True, 64, 0),    # hd 256, window
    (2, 100, 100, 2, 1, 128, True, 0, 40),    # a view of a longer cache
    (1, 300, 300, 2, 2, 64, True, 100, 0),    # hd 64, window
])
def test_emulated_forward_matches_jax(lib, B, Tq, Tk, H, Hkv, hd, causal,
                                      window, extra):
    """Keys past Tk of the cache hold NaN: the kernel never reads them."""
    tq, tk, tv = _inputs(Tq + hd + H, [(B, Tq, H, hd), (B, Tk, Hkv, hd),
                                       (B, Tk, Hkv, hd)])
    kc, vc = (torch.full((B, Tk + extra, Hkv, hd), float("nan"))
              for _ in range(2))
    kc[:, :Tk], vc[:, :Tk] = tk, tv
    q = tq.transpose(1, 2)
    k, v = kc[:, :Tk].transpose(1, 2), vc[:, :Tk].transpose(1, 2)
    o, lse = emulated_forward(lib, q, k, v, causal, window)
    want, want_lse = _jax_forward(tq.numpy(), tk.numpy(), tv.numpy(),
                                  causal=causal, window=window)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=FWD_TOL, rtol=0)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_grads(q, k, v, do, causal, window):
    def fn(q, k, v):
        return _tr(j_attention_ref(_tr(q), _tr(k), _tr(v), causal=causal,
                                   window=window))
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(do)


def _jax_vjp(nps, causal, window):
    """(dq, dk, dv) [B, T, H, hd] of ``jax.vjp`` of the oracle."""
    return [np.asarray(x) for x in _jax_grads(*nps, causal=causal,
                                              window=window)]


def _hold_bwd(got, want):
    for a, b in zip(got, want):
        a = a.transpose(1, 2).numpy()
        assert a.shape == b.shape
        excess = float((np.abs(a - b) - BWD_TOL * np.abs(b)).max())
        assert excess <= BWD_TOL, excess


@pytest.mark.parametrize("B,T,H,Hkv,hd,causal,window", [
    (1, 200, 4, 2, 64, True, 0),      # ragged T, GQA 2
    (1, 1000, 2, 1, 64, True, 0),     # T 1,000: many tiles and shares
    (1, 256, 2, 2, 128, False, 0),    # non-causal
    (2, 200, 4, 1, 128, True, 64),    # window, GQA 4, two batch rows
    (1, 130, 10, 1, 256, True, 64),   # recurrentgemma's heads, window
    (1, 100, 2, 2, 256, False, 0),    # hd 256, non-causal
])
def test_emulated_backward_matches_jax_vjp(lib, B, T, H, Hkv, hd, causal,
                                           window):
    tq, tk, tv, tdo = _inputs(T + hd + H, [(B, T, H, hd), (B, T, Hkv, hd),
                                           (B, T, Hkv, hd), (B, T, H, hd)])
    q, k, v, do = (x.transpose(1, 2) for x in (tq, tk, tv, tdo))
    o, lse = emulated_forward(lib, q, k, v, causal, window)
    got = emulated_backward(lib, q, k, v, o, lse, do, causal, window)
    _hold_bwd(got, _jax_vjp([x.numpy() for x in (tq, tk, tv, tdo)], causal,
                            window))


#: Blocks of queries at an offset against every key (the cases of
#: tests/test_torch_flash_sm90.py): (B, Tq, Tk, H, Hkv, hd, window,
#: q_offset); the shares planned from the offset's key extent.
OFFSET_CASES = [
    (1, 128, 512, 7, 1, 64, 0, 384),
    (1, 100, 400, 2, 1, 64, 0, 200),
    (1, 64, 256, 4, 2, 128, 0, 64),
    (1, 80, 240, 2, 1, 256, 100, 120),
]


@functools.partial(jax.jit, static_argnames=("window", "q_offset"))
def _jax_offset(q, k, v, do, window, q_offset):
    """JAX's attention_chunked of a block of queries at ``q_offset``
    (model layout), its log-sum-exp, and the vjp at ``do``."""
    def fn(q, k, v):
        return j_attention_chunked(q, k, v, causal=True, window=window,
                                   q_chunk=q.shape[1], q_offset=q_offset)
    o, vjp = jax.vjp(fn, q, k, v)
    hd, H, Hkv = q.shape[3], q.shape[2], k.shape[2]
    kr = jnp.repeat(_tr(k), H // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", _tr(q), kr) / math.sqrt(hd)
    qpos = q_offset + jnp.arange(q.shape[1])[:, None]
    kpos = jnp.arange(k.shape[1])[None, :]
    mask = kpos > qpos
    if window > 0:
        mask |= kpos <= qpos - window
    s = jnp.where(mask, -1.0e30, s)
    return o, jax.nn.logsumexp(s, axis=-1), vjp(do)


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd,window,q_offset", OFFSET_CASES)
def test_emulated_kernels_with_a_query_offset_match_jax(
        lib, B, Tq, Tk, H, Hkv, hd, window, q_offset):
    """Forward and backward with query row i at q_offset + i against JAX's
    ``attention_chunked(q_offset=...)`` and its ``jax.vjp``, at FWD_TOL
    and BWD_TOL (the outputs start as NaN: the dk, dv rows of keys no
    query reaches are written, as zeros)."""
    tq, tk, tv, tdo = _inputs(Tq + Tk + hd + q_offset,
                              [(B, Tq, H, hd), (B, Tk, Hkv, hd),
                               (B, Tk, Hkv, hd), (B, Tq, H, hd)])
    q, k, v, do = (x.transpose(1, 2) for x in (tq, tk, tv, tdo))
    o, lse = emulated_forward(lib, q, k, v, True, window, q_offset=q_offset)
    want, want_lse, grads = _jax_offset(*[x.numpy() for x in
                                          (tq, tk, tv, tdo)],
                                        window=window, q_offset=q_offset)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=FWD_TOL, rtol=0)
    got = emulated_backward(lib, q, k, v, o, lse, do, True, window,
                            q_offset=q_offset)
    _hold_bwd(got, [np.asarray(g) for g in grads])
    if q_offset + Tq < Tk:
        for g in got[1:]:
            assert not g[:, :, q_offset + Tq:].any()


def test_shares_are_deterministic(lib):
    """Two runs with shares are bit-equal (forward, dq, dk, dv); one share
    (each output written by its own kernel) agrees with them to float32
    sums in another order and holds against JAX as well."""
    B, T, H, Hkv, hd = 1, 200, 3, 1, 64
    tq, tk, tv, tdo = _inputs(5, [(B, T, H, hd), (B, T, Hkv, hd),
                                  (B, T, Hkv, hd), (B, T, H, hd)])
    q, k, v, do = (x.transpose(1, 2) for x in (tq, tk, tv, tdo))
    plan = (fa.f32_split(B, H, T, T, hd, EMU_SMS),
            fb.f32_kv_split(B, H, Hkv, T, T, hd, EMU_SMS),
            fb.f32_dq_split(B, H, T, T, hd, EMU_SMS))
    assert min(plan) > 1
    o, lse = emulated_forward(lib, q, k, v, True, 0)
    o2, lse2 = emulated_forward(lib, q, k, v, True, 0)
    o1, lse1 = emulated_forward(lib, q, k, v, True, 0, split=1)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    torch.testing.assert_close(o, o1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, lse1, atol=1e-6, rtol=1e-6)
    a = emulated_backward(lib, q, k, v, o, lse, do, True, 0)
    b = emulated_backward(lib, q, k, v, o, lse, do, True, 0)
    one = emulated_backward(lib, q, k, v, o, lse, do, True, 0, 1, 1)
    for x, y, z in zip(a, b, one):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, atol=1e-5, rtol=1e-5)
    _hold_bwd(one, _jax_vjp([x.numpy() for x in (tq, tk, tv, tdo)], True, 0))


def test_shares_fill_the_card_only_where_blocks_are_few():
    # qwen3 (8 key/value heads) at B 1 x T 2,048: 256 blocks, about two
    # waves of one block an SM: no shares; nor at the trainer's B 2 x T 4,096
    assert fb.f32_kv_split(1, 16, 8, 2048, 2048, 128, 132) == 1
    assert fb.f32_kv_split(2, 16, 8, 4096, 4096, 128, 132) == 1
    # qwen2 (2 key/value heads, hd 64, two blocks an SM) and
    # recurrentgemma (MQA of 256): the shares make up the blocks
    assert fb.f32_kv_split(1, 14, 2, 2048, 2048, 64, 132) == 9
    assert fb.f32_kv_split(1, 10, 1, 2048, 2048, 256, 132) == 9
    # never more shares than a key tile's items
    assert fb.f32_kv_split(1, 2, 1, 40, 40, 128, 132) == 2
    # the forward and dq: qwen2 at B 1 x T 2,048 (224 blocks, two an SM)
    # cut in three; qwen3 and recurrentgemma (more than a wave) not at all
    assert [fa.f32_split(1, H, 2048, 2048, hd, 132)
            for H, hd in ((16, 128), (14, 64), (10, 256))] == [1, 3, 1]
    assert [fb.f32_dq_split(1, H, 2048, 2048, hd, 132)
            for H, hd in ((16, 128), (14, 64), (10, 256))] == [1, 3, 1]
    assert fa.f32_split(8, 16, 2048, 2048, 128, 132) == 1
    # a block of queries at an offset: the longest loop is the last
    # query's keys (qwen2's 14 heads, T 2,048 cut in 16: 128 queries a
    # rank; rank 0's loops are 2 key tiles long, rank 15's 32, which
    # the dq kernel cuts in as many shares as its blocks fill the card)
    assert fa.key_extent(128, 2048, True, 1920) == 2048
    assert fa.key_extent(128, 2048, True, 0) == 128
    assert fa.key_extent(128, 2048, False, 0) == 2048
    assert [fa.f32_split(1, 14, 128, 2048, 64, 132, True, o)
            for o in (0, 1920)] == [2, 32]
    assert [fb.f32_dq_split(1, 14, 128, 2048, 64, 132, True, o)
            for o in (0, 1920)] == [4, 38]
    # one key tile: nothing to cut
    assert fa.f32_split(1, 1, 64, 64, 128, 132) == 1


def test_shared_memory_and_resident_warps():
    """The helpers follow the sources' layouts (and their notes' tables);
    every block fits the opt-in limit; an H100 SM holds at least 8 warps of
    each kernel at hd 64 and 128, and at least 4 at hd 256 (it holds 8)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    for const in ("kThreads = HD == 256 ? 256 : 128",
                  "kBQ = HD == 64 ? 128 : 64", "kBK = 64",
                  "kSmem =\n      4 * (kBQ * HD + 2 * kBK * HD + kBK * kBQ "
                  "+ 2 * kBQ)"):
        assert f"static constexpr int {const};" in src
    assert fa.F32_THREADS == {64: 128, 128: 128, 256: 256}
    assert fa.F32_BQ == {64: 128, 128: 64, 256: 64}
    fwd = {hd: fa.smem_bytes(hd) for hd in fa.HEAD_DIMS}
    assert fwd == {64: 99_328, 128: 115_200, 256: 213_504}
    for hd, n in fwd.items():
        assert f"{n:,}" in src

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for const in ("kThreads = HD == 64 ? 128 : 256",
                  "kBQ = HD == 256 ? 64 : 128", "kBK = kNB * kTB",
                  "kBK = 64", "kBQ = HD == 64 ? 32 : HD == 128 ? 64 : 16"):
        assert f"static constexpr int {const};" in src
    bwd = {hd: fb.smem_bytes(hd) for hd in fb.HEAD_DIMS}
    assert bwd == {64: (114_688, 81_920), 128: (212_992, 229_376),
                   256: (200_704, 204_800)}
    for pair in bwd.values():
        for n in pair:
            assert f"{n:,}" in src
    assert all(n <= SMEM_LIMIT for n in fwd.values())
    assert all(n <= SMEM_LIMIT for pair in bwd.values() for n in pair)

    warps = {hd: (fa.resident_warps(fwd[hd], fa.F32_THREADS[hd]),
                  fa.resident_warps(bwd[hd][0], fb.F32_DQ_THREADS[hd]),
                  fa.resident_warps(bwd[hd][1], fb.F32_KV_THREADS[hd]))
             for hd in fa.HEAD_DIMS}
    assert warps == {64: (8, 8, 8), 128: (8, 8, 8), 256: (8, 8, 8)}
    for hd, ws in warps.items():
        assert min(ws) >= (8 if hd <= 128 else 4)
    # today's first design, for comparison: one 4-warp block an SM at hd
    # 128 (116,224 B of dk/dv shared memory) -- the count the helper gives
    assert fa.resident_warps(116_224, 128) == 4
