"""The bf16 flash-attention kernels (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``: wgmma on tiles brought in by TMA) on
the CPU: the host-side code they depend on, and their device code run under
a CPU emulation of Hopper (tests/sm90).

* The TMA geometry the wrappers compute (dims, byte strides, box) addresses
  exactly the elements of a ``transpose(1, 2)`` view of [B,T,H,hd] and of a
  ``cache[:, :Tk]`` slice of a longer cache, checked against the views'
  storage offsets and strides; misaligned layouts raise.
* The dispatch: bf16 goes to the ``wgmma`` kernels, float32 to the FMA
  kernels, anything else raises ``ValueError``.
* Every instantiation's shared memory fits a block's 232,448 bytes.
* The emulated kernels (g++, threads at barriers, TMA and wgmma computed
  from the descriptors) against the JAX package's oracle and its ``vjp``, on
  inputs drawn with numpy and rounded to bf16: forward within 2e-2
  (tests/test_kernels.py's bf16 tolerance), gradients within 1e-2 of each
  one's largest magnitude (chip_smoke.py phase 10's bf16 bound).

The kernels themselves run on the card in tests/test_torch_gpu.py and
chip_smoke.py phases 7 and 10.
"""
import importlib
import os
import re
import shutil
import struct
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

EMULATOR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sm90")
SMEM_LIMIT = 232_448


def _addresses(x):
    """Storage index of every element of ``x`` [B, N, T, hd], from its
    storage offset and strides."""
    idx = torch.arange(x.untyped_storage().nbytes() // x.element_size())
    return idx.as_strided(x.shape, x.stride(), x.storage_offset())


def _tma_addresses(x, geom):
    """Storage index of every element the TMA map ``geom`` addresses over
    x's storage, in [B, N, T, hd] order: base + c0 * es + c1 * s_T +
    c2 * s_N + c3 * s_B, over the map's dims."""
    hd, T, N, B, sT, sN, sB = geom[:7]
    es = x.element_size()
    b, n, t, d = torch.meshgrid(torch.arange(B), torch.arange(N),
                                torch.arange(T), torch.arange(hd),
                                indexing="ij")
    byte = x.storage_offset() * es + d * es + t * sT + n * sN + b * sB
    assert bool((byte % es == 0).all())
    return byte // es


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_tma_geometry_addresses_exactly_the_view(hd):
    B, T, H, Hkv, Tmax, Tk = 2, 37, 3, 2, 50, 29
    q = torch.zeros(B, T, H, hd, dtype=torch.bfloat16).transpose(1, 2)
    geom = fa.tma_geometry(q, fa.SM90_BQ)
    assert geom == [hd, T, H, B, H * hd * 2, hd * 2, T * H * hd * 2, 64,
                    fa.SM90_BQ]
    assert torch.equal(_tma_addresses(q, geom), _addresses(q))
    # a key view cut from a longer cache: the map ends at Tk, not at Tmax
    cache = torch.zeros(B, Tmax, Hkv, hd, dtype=torch.bfloat16)
    k = cache[:, :Tk].transpose(1, 2)
    geom = fa.tma_geometry(k, fa.sm90_bk(hd))
    assert geom[:4] == [hd, Tk, Hkv, B]
    assert geom[6] == Tmax * Hkv * hd * 2
    assert geom[7:] == [64, fa.sm90_bk(hd)]
    got = _tma_addresses(k, geom)
    assert torch.equal(got, _addresses(k))
    # no address past position Tk - 1 of any (batch row, head)
    pos = (got % (Tmax * Hkv * hd)) // (Hkv * hd)
    assert int(pos.max()) == Tk - 1
    # a view that starts inside the storage keeps its offset
    k2 = cache[:, 3:3 + Tk].transpose(1, 2)
    assert torch.equal(_tma_addresses(k2, fa.tma_geometry(k2, 64)),
                       _addresses(k2))


def test_misaligned_layouts_raise():
    x = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    fa.tma_geometry(x, 128)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        fa.tma_geometry(x.transpose(2, 3), 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.tma_geometry(torch.zeros(1, 4, 64, 65, dtype=torch.bfloat16)
                        [..., 1:], 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.tma_geometry(torch.zeros(1, 4, 64, 68, dtype=torch.bfloat16)
                        [..., :64], 128)


def test_dispatch_by_dtype_and_head_width():
    for hd in fa.HEAD_DIMS:
        assert fa.route(torch.bfloat16, hd) == "wgmma"
        assert fa.route(torch.float32, hd) == "fma"
    for hd in fb.HEAD_DIMS:
        assert fa.route(torch.bfloat16, hd, fb.HEAD_DIMS) == "wgmma"
        assert fa.route(torch.float32, hd, fb.HEAD_DIMS) == "fma"
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fa.route(dt, 128)
    for hd in (32, 96, 512):
        with pytest.raises(ValueError, match="hd in"):
            fa.route(torch.bfloat16, hd)
        with pytest.raises(ValueError, match="hd in"):
            fa.route(torch.bfloat16, hd, fb.HEAD_DIMS)
    assert fb.HEAD_DIMS == fa.HEAD_DIMS == (64, 128, 256)


def test_shared_memory_fits_every_instantiation():
    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    assert "kBK = HD == 256 ? 64 : 128" in src
    assert "kBQ = 64 * kWarpgroups" in src and "kWarpgroups = 2" in src
    sizes = {hd: fa.sm90_smem_bytes(hd) for hd in fa.HEAD_DIMS}
    # Q (128 x hd) + 2 x (K + V) (bk x hd), bf16, + 1,024 for alignment
    assert sizes == {64: 82_944, 128: 164_864, 256: 197_632}
    src = (build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    for const in ("kQBQ = 64 * kWarpgroups", "kQBK = 64",
                  "kKBK = 64 * kWarpgroups", "kKBQ = 64"):
        assert f"constexpr int {const};" in src
    assert "kSplit = HD > 128 ? 2 : 1" in src
    assert "kStages = HD > 128 ? 1 : 2" in src
    bwd = {hd: fb.sm90_smem_bytes(hd) for hd in fb.HEAD_DIMS}
    # hd 256: Q + dO (128 x 256) and one stage of K + V (64 x 256), bf16;
    # K + V (128 x 256), one stage of Q + dO and of lse + delta
    assert bwd == {64: (66_560, 67_584), 128: (132_096, 133_120),
                   256: (197_632, 198_144)}
    assert all(b <= SMEM_LIMIT for b in sizes.values())
    assert all(b <= SMEM_LIMIT for pair in bwd.values() for b in pair)


def test_sources_flags_and_instances():
    for src in ("flash_attention_sm90.cu", "flash_attention_bwd_sm90.cu"):
        assert build.SOURCE_FLAGS[src] == build._BASE_FLAGS
        assert "--use_fast_math" not in build.SOURCE_FLAGS[src]
        text = (build.CSRC / src).read_text()
        assert '#include "sm90.cuh"' in text
        assert "-lcuda" not in " ".join(build.SOURCE_FLAGS[src])
    hdr = (build.CSRC / "sm90.cuh").read_text()
    assert "cudaGetDriverEntryPoint" in hdr
    names = {
        "_ZN56_GLOBAL__N__f19cc713_23_flash_attention_sm90_cu_bed5ab3f21"
        "flash_fwd_sm90_kernelILi256EEEv14CUtensorMap_stS1_S1_P13__nv_"
        "bfloat16Pfiiiixxxiif": ("fwd", 256),
        "_ZN60_GLOBAL__N__7c28ccfb_27_flash_attention_bwd_sm90_cu_fb3b6c9c24"
        "flash_bwd_dq_sm90_kernelILi64EEEv": ("dq", 64),
        "_ZN60_GLOBAL__N__7c28ccfb_27_flash_attention_bwd_sm90_cu_fb3b6c9c26"
        "flash_bwd_dkdv_sm90_kernelILi128EEEv": ("dkdv", 128)}
    for name, inst in names.items():
        assert build.flash_attention_sm90_instance(name) == inst
        assert build.flash_attention_instance(name) is None
        assert build.flash_attention_bwd_instance(name) is None


# ------------------------------------------------------------ emulation --

def _cut(source, namespace):
    """The device code of ``source`` (up to its launch function), in its
    own namespace, for g++."""
    s = (build.CSRC / source).read_text()
    s = s[:s.index("template <int HD>\nint launch(")]
    s = re.sub(r'#include [<"].*[>"]\n', "", s)
    s = s.replace("extern __shared__ uint8_t smem_raw[];", "using ::smem_raw;")
    return f"namespace {namespace} {{\n{s}\n}}}}\n"


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulator")
    d = tmp_path_factory.mktemp("sm90")
    (d / "kernels_cut.inc").write_text(
        _cut("flash_attention_sm90.cu", "fwdk")
        + _cut("flash_attention_bwd_sm90.cu", "bwdk"))
    for stub in ("cuda.h", "cuda_bf16.h", "cuda_runtime.h"):
        (d / stub).write_text("")
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fno-strict-aliasing",
                    "-pthread", f"-I{d}", f"-I{EMULATOR}", f"-I{build.CSRC}",
                    "-o", str(exe), os.path.join(EMULATOR, "harness.cpp")],
                   check=True, capture_output=True, timeout=600)
    return str(exe)


def _run(harness, mode, header, blobs, tmp_path):
    fin, fout = tmp_path / "in", tmp_path / "out"
    with open(fin, "wb") as f:
        f.write(struct.pack(f"{len(header)}q", *header))
        for b in blobs:
            f.write(b)
    subprocess.run([harness, mode, str(fin), str(fout)], check=True,
                   timeout=600)
    return fout.read_bytes()


def _from(data, like):
    """A tensor with ``like``'s storage size, offset and strides, from
    raw bytes."""
    t = torch.frombuffer(bytearray(data), dtype=like.dtype)
    return t.as_strided(like.shape, like.stride(), like.storage_offset())


def _storage(x):
    return bytes(x.untyped_storage())


def emulated_forward(harness, tmp_path, q, k, v, causal, window,
                     q_offset=0):
    """(o, lse) of the bf16 forward kernel, run under the emulator with
    the wrapper's TMA geometry (query row i at position q_offset + i)."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    bk = fa.sm90_bk(hd)
    geom = (fa.tma_geometry(q, fa.SM90_BQ) + fa.tma_geometry(k, bk)
            + fa.tma_geometry(v, bk))
    xs = (q, k, v, o)
    header = ([hd, B, H, Hkv, Tq, Tk, int(causal), window, 1] + geom
              + [o.stride(i) for i in (0, 1, 2)]
              + [x.untyped_storage().nbytes() // 2 for x in xs]
              + [x.storage_offset() for x in xs] + [q_offset])
    data = _run(harness, "fwd", header, [_storage(x) for x in xs[:3]],
                tmp_path)
    n = o.untyped_storage().nbytes()
    lse = torch.frombuffer(bytearray(data[n:]), dtype=torch.float32)
    return _from(data[:n], o), lse.reshape(B, H, Tq)


def emulated_backward(harness, tmp_path, q, k, v, o, lse, do, causal,
                      window, q_offset=0):
    """(dq, dk, dv) of the bf16 backward kernels under the emulator, with
    the wrapper's TMA geometry and padded lse / delta."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    pitch = -(-Tq // 4) * 4
    lse_p = torch.zeros(B, H, pitch)
    lse_p[..., :Tq] = lse
    delta = torch.zeros(B, H, pitch)
    delta[..., :Tq] = (do.float() * o.float()).sum(-1)
    outs = [torch.empty_like(x) for x in (q, k, v)]
    geom = []
    for rq, rk in ((fb.SM90_DQ_BQ, fb.SM90_DQ_BK),
                   (fb.SM90_KV_BQ, fb.SM90_KV_BK)):
        geom += (fa.tma_geometry(q, rq) + fa.tma_geometry(k, rk)
                 + fa.tma_geometry(v, rk) + fa.tma_geometry(do, rq))
    xs = (q, k, v, do, *outs)
    header = ([hd, B, H, Hkv, Tq, Tk, int(causal), window, pitch] + geom
              + [x.stride(i) for x in outs for i in (0, 1, 2)]
              + [x.untyped_storage().nbytes() // 2 for x in xs]
              + [x.storage_offset() for x in xs] + [q_offset])
    data = _run(harness, "bwd", header,
                [_storage(x) for x in xs[:4]]
                + [lse_p.numpy().tobytes(), delta.numpy().tobytes()],
                tmp_path)
    got, pos = [], 0
    for x in outs:
        n = x.untyped_storage().nbytes()
        got.append(_from(data[pos:pos + n], x))
        pos += n
    return got


def _bf16_inputs(seed, shapes):
    """numpy draws rounded to bf16: the port's tensors, and the same values
    in float32 for JAX."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
          .bfloat16() for s in shapes]
    return ts, [t.float().numpy() for t in ts]


def _jax_forward(q, k, v, causal, window):
    def tr(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3)
    return np.asarray(j_attention_ref(tr(q), tr(k), tr(v), causal=causal,
                                      window=window)).transpose(0, 2, 1, 3)


def test_fragment_layouts_and_swizzle(harness):
    out = subprocess.run([harness, "layout"], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and "layout ok" in out.stdout


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd,causal,window,extra", [
    (1, 200, 200, 2, 1, 64, True, 0, 0),      # ragged T, GQA
    (1, 70, 130, 2, 2, 128, True, 0, 0),      # Tq != Tk
    (1, 256, 256, 2, 1, 128, False, 0, 0),    # non-causal
    (1, 300, 300, 1, 1, 256, True, 100, 0),   # hd 256, window
    (2, 150, 150, 2, 1, 128, True, 0, 50),    # a view of a longer cache
])
def test_emulated_forward_matches_jax(harness, tmp_path, B, Tq, Tk, H, Hkv,
                                      hd, causal, window, extra):
    """Keys past Tk of the cache hold NaN: the map ends at the view."""
    (tq, tk, tv), (nq, nk, nv) = _bf16_inputs(
        Tq + hd + H, [(B, Tq, H, hd), (B, Tk, Hkv, hd), (B, Tk, Hkv, hd)])
    kc, vc = (torch.full((B, Tk + extra, Hkv, hd), float("nan"),
                         dtype=torch.bfloat16) for _ in range(2))
    kc[:, :Tk], vc[:, :Tk] = tk, tv
    q = tq.transpose(1, 2)
    k, v = kc[:, :Tk].transpose(1, 2), vc[:, :Tk].transpose(1, 2)
    o, lse = emulated_forward(harness, tmp_path, q, k, v, causal, window)
    want = _jax_forward(nq, nk, nv, causal, window)
    got = o.transpose(1, 2).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    from repro_torch.kernels.flash_attention import attention_ref
    _, ref_lse = attention_ref(q, k, v, causal=causal, window=window,
                               return_lse=True)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("B,T,H,Hkv,hd,causal,window", [
    (1, 200, 2, 1, 64, True, 0),
    (1, 256, 2, 2, 128, False, 0),
    (1, 200, 4, 2, 128, True, 64),
    (1, 130, 10, 1, 256, True, 64),   # recurrentgemma's heads, window
    (1, 256, 2, 1, 256, False, 0),    # hd 256, non-causal
])
def test_emulated_backward_matches_jax_vjp(harness, tmp_path, B, T, H, Hkv,
                                           hd, causal, window):
    (tq, tk, tv, tdo), nps = _bf16_inputs(
        T + hd + H, [(B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd),
                     (B, T, H, hd)])
    q, k, v, do = (x.transpose(1, 2) for x in (tq, tk, tv, tdo))
    o, lse = emulated_forward(harness, tmp_path, q, k, v, causal, window)
    got = emulated_backward(harness, tmp_path, q, k, v, o, lse, do, causal,
                            window)

    def fn(q, k, v):
        def tr(a):
            return a.transpose(0, 2, 1, 3)
        return tr(j_attention_ref(tr(q), tr(k), tr(v), causal=causal,
                                  window=window))
    _, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in nps[:3]])
    want = [np.asarray(x) for x in vjp(jnp.asarray(nps[3]))]
    for a, b in zip(got, want):
        a = a.transpose(1, 2).float().numpy()
        assert a.shape == b.shape
        err = float(np.abs(a - b).max()) / float(np.abs(b).max())
        assert err <= 1e-2, err


#: Blocks of queries at an offset against every key, as context-parallel
#: attention runs them: (B, Tq, Tk, H, Hkv, hd, window, q_offset).  The
#: last block of four (qwen2-0.5b's hd 64 GQA 7), a middle block whose
#: last key tiles no query reaches (their dk, dv zeros), hd 128 at T / 4
#: and hd 256 with a window.
OFFSET_CASES = [
    (1, 128, 512, 7, 1, 64, 0, 384),
    (1, 100, 400, 2, 1, 64, 0, 200),
    (1, 64, 256, 4, 2, 128, 0, 64),
    (1, 150, 300, 2, 1, 256, 100, 150),
]


def _jax_offset(q, k, v, window, q_offset):
    """JAX's attention_chunked (model layout) of a block of queries whose
    first sits at ``q_offset``, against keys from 0."""
    return j_attention_chunked(q, k, v, causal=True, window=window,
                               q_chunk=q.shape[1], q_offset=q_offset)


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,hd,window,q_offset", OFFSET_CASES)
def test_emulated_kernels_with_a_query_offset_match_jax(
        harness, tmp_path, B, Tq, Tk, H, Hkv, hd, window, q_offset):
    """The forward and the backward kernels with query row i at position
    q_offset + i, against JAX's ``attention_chunked(q_offset=...)`` and
    its ``jax.vjp`` at the tolerances above (every dk, dv row written:
    the outputs start as NaN)."""
    (tq, tk, tv, tdo), nps = _bf16_inputs(
        Tq + Tk + hd + q_offset, [(B, Tq, H, hd), (B, Tk, Hkv, hd),
                                  (B, Tk, Hkv, hd), (B, Tq, H, hd)])
    q, k, v, do = (x.transpose(1, 2) for x in (tq, tk, tv, tdo))
    o, lse = emulated_forward(harness, tmp_path, q, k, v, True, window,
                              q_offset)
    want = np.asarray(_jax_offset(*[jnp.asarray(x) for x in nps[:3]],
                                  window, q_offset))
    np.testing.assert_allclose(o.transpose(1, 2).float().numpy(), want,
                               atol=2e-2, rtol=0)
    from repro_torch.kernels.flash_attention import attention_ref
    _, ref_lse = attention_ref(q, k, v, window=window, return_lse=True,
                               q_offset=q_offset)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=1e-5)
    got = emulated_backward(harness, tmp_path, q, k, v, o, lse, do, True,
                            window, q_offset)
    _, vjp = jax.vjp(lambda a, b, c: _jax_offset(a, b, c, window, q_offset),
                     *[jnp.asarray(x) for x in nps[:3]])
    for a, b in zip(got, vjp(jnp.asarray(nps[3]))):
        a, b = a.transpose(1, 2).float().numpy(), np.asarray(b)
        assert a.shape == b.shape
        err = float(np.abs(a - b).max()) / float(np.abs(b).max())
        assert err <= 1e-2, err
    if q_offset + Tq < Tk:       # keys no query reaches
        for g in got[1:]:
            assert not g[:, :, q_offset + Tq:].float().any()
