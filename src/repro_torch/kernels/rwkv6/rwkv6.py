"""RWKV-6 WKV recurrence: the hand-written CUDA kernels' wrappers.

:func:`wkv_bhtd` replaces the JAX package's Pallas TPU kernel
``repro/kernels/rwkv6/rwkv6.py::wkv_bhtd`` (``_wkv_kernel``).  The kernels
are ``kernels/csrc/wkv.cu``, built by :mod:`repro_torch.kernels.build` at
first use; its source note says what bounds them on an H100 and how they
are laid out.  Two routes, chosen from dtype and shapes by
:func:`wkv_plan`: the chunked kernel (bf16 r, k, v over a chunk or more:
the serving prefill) and the step kernel (float32, and anything shorter
than a chunk, such as decode).  Beyond the TPU kernel both take an
initial state and return the final one, which serving carries from the
prefill into decode.  :func:`wkv_bwd_bhtd` is the recurrence's backward
(the port's own: the TPU kernel has no backward, and JAX differentiates
its model's ``lax.scan``), with two routes by :func:`wkv_bwd_plan`:
``kernels/csrc/wkv_bwd_chunk.cu`` (bf16 r, k, v over a chunk or more: the
trainer's call; a state pass, then one block per chunk on the tensor
cores) and ``kernels/csrc/wkv_bwd.cu`` (the step route: float32, short or
misaligned inputs).  For tensors
on the CPU a wrapper computes the plain version
(:func:`~repro_torch.kernels.rwkv6.ref.wkv_ref`,
:func:`~repro_torch.kernels.rwkv6.ref.wkv_bwd_ref`); for CUDA tensors it
launches its kernel on the current stream without synchronising, or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import wkv_bwd_ref, wkv_ref

#: The kernel's head width (rwkv6's).
HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: (r/k/v dtype, w dtype) pairs the kernels are instantiated for.
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16)}
#: Steps of a chunk of the chunked kernel (csrc/wkv.cu ``kL``), and
#: between the backward's checkpoints (csrc/wkv_bwd.cu ``kL``).
CHUNK = 64
#: Steps between the backward's sub-checkpoints (csrc/wkv_bwd.cu ``kNS``).
BWD_SUB = 8
#: Dynamic shared memory of a backward block (csrc/wkv_bwd.cu
#: ``kSmemBytes``): a sub-chunk's states (BWD_SUB x 256 threads x 16
#: floats), its five staged inputs, three gradient rows and dv's 8 warp
#: partials, float32.
WKV_BWD_SMEM = 4 * (BWD_SUB * 256 * 16 + 5 * BWD_SUB * 64 + 3 * BWD_SUB * 64
                    + BWD_SUB * 8 * 64)
_ROUTE_CODE = {"step": 0, "chunk": 1}


def chunk_smem_bytes(nj: int, w_bytes: int) -> int:
    """Dynamic shared memory of a chunked block over ``nj`` columns with a
    decay of ``w_bytes`` bytes an element (csrc/wkv.cu ``Chunk::kSmem``)."""
    tiles = 6 * 2048 + 2 * 8192 + nj * 128   # S^T over the r, k inputs
    work = CHUNK * 72 * 4 + 4 * 256 * 4 + 10 * 64 * 4 + 2 * 64 * 4
    inputs = 2 * CHUNK * 64 * 2 + CHUNK * nj * 2 + CHUNK * 64 * w_bytes
    return tiles + work + inputs + 1024


def _aligned(x) -> bool:
    """Base address, and the strides of every dimension but the last that
    is longer than 1, 16-byte aligned: rows cp.async reads in 16-byte
    pieces."""
    es = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        (x.stride(d) * es) % 16 == 0 for d in range(3) if x.shape[d] > 1)


def wkv_plan(r, k, v, w, y, n_sms: int) -> tuple[str, int]:
    """(route, columns a block) for [B, H, T, 64] r, k, v, w and the output
    y on a card of ``n_sms`` SMs.  ``"chunk"`` for bf16 r, k, v with T of a
    chunk or more whose rows cp.async can read in 16-byte pieces (base
    addresses, and the strides of every dimension longer than 1, 16-byte
    aligned); then 64 columns a block where B x H blocks give at least
    7/8 of the SMs one, else 32 (two blocks a head).  Else ``"step"``,
    whose block covers all 64 columns."""
    B, H, T, _ = r.shape
    if r.dtype != torch.bfloat16 or T < CHUNK or not all(
            _aligned(x) for x in (r, k, v, w, y)):
        return "step", 64
    return "chunk", 64 if 8 * B * H >= 7 * n_sms else 32


def wkv_bwd_plan(r, k, v, w, dy, n_sms: int) -> tuple[str, int]:
    """(route, columns a state-pass block) of the backward for [B, H, T,
    64] r, k, v, w and dy, by :func:`wkv_plan`'s rule: ``"chunk"``
    (csrc/wkv_bwd_chunk.cu) for bf16 r, k, v with T of a chunk or more and
    16-byte aligned rows, its state pass over 64 columns a block where B x
    H blocks give at least 7/8 of the SMs one, else 32; else ``"step"``
    (csrc/wkv_bwd.cu, a block over all 64 columns)."""
    return wkv_plan(r, k, v, w, dy, n_sms)


def bwd_state_smem_bytes(nj: int, w_bytes: int) -> int:
    """Dynamic shared memory of a state-pass block over ``nj`` columns
    (csrc/wkv_bwd_chunk.cu ``StateSmem::kSmem``): the operand tiles, two
    buffers of a chunk's inputs, and a state's split tiles on their way
    out."""
    buf = CHUNK * 64 * 2 + CHUNK * 64 * w_bytes + CHUNK * nj * 2
    return 2 * 8192 + nj * 128 + 2 * buf + 4 * 64 * 4 + 64 * 4 + 16384 + 1024


def bwd_chunk_smem_bytes(w_bytes: int) -> int:
    """Dynamic shared memory of a chunk-pass block (csrc/wkv_bwd_chunk.cu
    ``ChunkSmem::kSmem``): each of its two warpgroups' v, dy, state, kF and
    rE tiles, w, A's (then K's) float array, dA's diagonal blocks and the
    per-channel sums, rounded to 1 KB."""
    tiles = 2 * 8192 + 16384 + 16384 + 12288
    share = (tiles + CHUNK * 64 * w_bytes + CHUNK * 68 * 4 + 4 * 256 * 4
             + 25 * 64 * 4 + 5 * 4 * 64 * 4 + 3 * 64 * 4 + 2 * 64 * 4)
    return 2 * -(-share // 1024) * 1024 + 1024


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(r, k, v, w, u, S0):
    if any(x.dim() != 4 for x in (r, k, v, w)):
        raise ValueError("wkv_bhtd takes r, k, v, w [B, H, T, hd]")
    B, H, T, hd = r.shape
    if any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"wkv_bhtd: r, k, v, w shapes differ "
                         f"({[tuple(x.shape) for x in (r, k, v, w)]})")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv_bhtd: u {tuple(u.shape)} is not [H, hd] = "
                         f"{(H, hd)}")
    if S0 is not None and tuple(S0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv_bhtd: S0 {tuple(S0.shape)} is not "
                         f"[B, H, hd, hd] = {(B, H, hd, hd)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"wkv_bhtd: r, k, v dtypes differ ({r.dtype}, "
                         f"{k.dtype}, {v.dtype})")
    if len({x.device for x in (r, k, v, w, u)
            + (() if S0 is None else (S0,))}) != 1:
        raise ValueError("wkv_bhtd: inputs on different devices")


def wkv_bhtd(r, k, v, w, u, S0=None):
    """r, k, v, w [B, H, T, hd]; u [H, hd]; S0 [B, H, hd, hd] or None ->
    (y [B, H, T, hd] in r's dtype, S_final [B, H, hd, hd] float32).  Any
    strides whose last one is 1: a ``transpose(1, 2)`` view of the model's
    [B, T, H, hd] tensors is read in place, and ``y`` is allocated with r's
    strides.

    CPU tensors: the plain version.  CUDA tensors: one launch of a kernel
    (r/k/v float32 with w float32; r/k/v bf16 with w float32 or bf16; hd
    64; its route by :func:`wkv_plan`), or an exception."""
    _check(r, k, v, w, u, S0)
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, w, u, S0)
    if r.device.type != "cuda":
        raise ValueError(f"the WKV kernel runs on CUDA (or, as its plain "
                         f"version, on the CPU), got {r.device}")
    B, H, T, hd = r.shape
    if (r.dtype, w.dtype) not in _PAIRS:
        raise ValueError(f"the WKV kernel takes r/k/v and w dtypes in "
                         f"{sorted((str(a), str(b)) for a, b in _PAIRS)}, "
                         f"got ({r.dtype}, {w.dtype})")
    if hd != HEAD_DIM:
        raise ValueError(f"the WKV kernel takes hd {HEAD_DIM}, got {hd}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.stride(3) != 1:
            raise ValueError(f"WKV kernel: {name} needs a contiguous last "
                             f"dimension, got strides {x.stride()}")
    u = u.float().contiguous()
    S0 = None if S0 is None else S0.float().contiguous()
    y = torch.empty_like(r)
    S = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B and H:
        from .. import build

        lib = build.load_wkv()
        route, nj = wkv_plan(r, k, v, w, y, _sm_count(r.device))
        strides = (ctypes.c_longlong * 15)(*[
            x.stride(i) for x in (r, k, v, w, y) for i in (0, 1, 2)])
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            err = lib.wkv_launch(
                _DTYPE_CODE[r.dtype], _DTYPE_CODE[w.dtype], r.data_ptr(),
                k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                None if S0 is None else S0.data_ptr(), y.data_ptr(),
                S.data_ptr(), B, H, T, strides, _ROUTE_CODE[route], nj,
                stream)
        if err != 0:
            raise RuntimeError(f"WKV kernel launch failed ({route} route): "
                               f"{build.cuda_error_string(lib, err, 'wkv')}")
        wkv_bhtd.launches += 1
        wkv_bhtd.route_launches[route] += 1
    return y, S


#: Kernel launches since the last reset (set to 0 to start counting), and
#: the same split by route.
wkv_bhtd.launches = 0
wkv_bhtd.route_launches = {"chunk": 0, "step": 0}


def wkv_bwd_scratch_floats(B: int, H: int, T: int) -> tuple[int, int]:
    """Floats of the backward kernel's two float32 scratch buffers: a state
    at every :data:`CHUNK`-step boundary, and at every :data:`BWD_SUB`-step
    boundary of one chunk, per (b, h)."""
    state = HEAD_DIM * HEAD_DIM
    return (B * H * -(-T // CHUNK) * state,
            B * H * (CHUNK // BWD_SUB) * state)


def wkv_bwd_chunk_scratch_floats(B: int, H: int, T: int) -> tuple[int, int]:
    """Floats of the chunked backward's scratch: each of its two state
    buffers (S at every chunk's start, the state gradient after every
    chunk; 16 KB a state, held as split bf16 tiles), and du's partials
    (one row of 64 per (b, h, chunk))."""
    nc = -(-T // CHUNK)
    return B * H * nc * HEAD_DIM * HEAD_DIM, B * H * nc * HEAD_DIM


def wkv_bwd_bhtd(r, k, v, w, u, S0, dy, dS_final=None):
    """The gradients of ``wkv_bhtd(r, k, v, w, u, S0)`` for the output
    gradients ``dy`` [B, H, T, hd] (r's dtype) and ``dS_final`` [B, H, hd,
    hd] (None: zeros) -> (dr, dk, dv in r's dtype, dw in w's, du [H, hd]
    and dS0 [B, H, hd, hd] float32).  r, k, v, w, dy: any strides whose last
    one is 1 (the model's [B, T, H, hd] through ``transpose(1, 2)``); dr,
    dk, dv, dw are allocated with r's and w's strides.

    CPU tensors: the plain version.  CUDA tensors: the route of
    :func:`wkv_bwd_plan` (the forward's type pairs; hd 64), or an
    exception: ``"chunk"`` launches the state pass and the chunk pass
    (csrc/wkv_bwd_chunk.cu), whose du per (b, h, chunk) the wrapper sums;
    ``"step"`` launches wkv_bwd_kernel (csrc/wkv_bwd.cu), whose du per row
    it sums over B.  No fallback from one route to the other."""
    _check(r, k, v, w, u, S0)
    B, H, T, hd = r.shape
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device:
        raise ValueError(f"wkv_bwd_bhtd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match r {tuple(r.shape)} {r.dtype} on "
                         f"{r.device}")
    if dS_final is not None and (tuple(dS_final.shape) != (B, H, hd, hd)
                                 or dS_final.device != r.device):
        raise ValueError(f"wkv_bwd_bhtd: dS_final {tuple(dS_final.shape)} "
                         f"is not [B, H, hd, hd] = {(B, H, hd, hd)} on "
                         f"{r.device}")
    if r.device.type == "cpu":
        return wkv_bwd_ref(r, k, v, w, u, S0, dy, dS_final)
    if r.device.type != "cuda":
        raise ValueError(f"the WKV backward kernel runs on CUDA (or, as its "
                         f"plain version, on the CPU), got {r.device}")
    if (r.dtype, w.dtype) not in _PAIRS:
        raise ValueError(f"the WKV backward kernel takes r/k/v and w dtypes "
                         f"in {sorted((str(a), str(b)) for a, b in _PAIRS)}, "
                         f"got ({r.dtype}, {w.dtype})")
    if hd != HEAD_DIM:
        raise ValueError(f"the WKV backward kernel takes hd {HEAD_DIM}, got "
                         f"{hd}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("dy", dy)):
        if x.stride(3) != 1:
            raise ValueError(f"WKV backward kernel: {name} needs a "
                             f"contiguous last dimension, got strides "
                             f"{x.stride()}")
    u = u.float().contiguous()
    S0, dS_final = (None if x is None else x.float().contiguous()
                    for x in (S0, dS_final))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    dS0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B and H:
        from .. import build

        route, nj = wkv_bwd_plan(r, k, v, w, dy, _sm_count(r.device))
        strides = (ctypes.c_longlong * 27)(*[
            x.stride(i) for x in (r, k, v, w, dy, dr, dk, dv, dw)
            for i in (0, 1, 2)])

        def ptr(x):
            return None if x is None else x.data_ptr()

        if route == "chunk":
            lib = build.load_wkv_bwd_chunk()
            n_state, n_du = wkv_bwd_chunk_scratch_floats(B, H, T)
            sc, dse = (torch.empty(n_state, dtype=torch.float32,
                                   device=r.device) for _ in range(2))
            du = torch.empty(n_du, dtype=torch.float32, device=r.device)
            with torch.cuda.device(r.device):
                stream = torch.cuda.current_stream(r.device).cuda_stream
                err = lib.wkv_bwd_chunk_launch(
                    _DTYPE_CODE[w.dtype],
                    *[ptr(x) for x in (r, k, v, w, dy, u, S0, dS_final, dr,
                                       dk, dv, dw, du, dS0, sc, dse)],
                    B, H, T, strides, nj, stream)
            kernel = "wkv_bwd_chunk"
        else:
            lib = build.load_wkv_bwd()
            n_ckpt, n_sub = wkv_bwd_scratch_floats(B, H, T)
            ckpt = torch.empty(n_ckpt, dtype=torch.float32, device=r.device)
            sub = torch.empty(n_sub, dtype=torch.float32, device=r.device)
            with torch.cuda.device(r.device):
                stream = torch.cuda.current_stream(r.device).cuda_stream
                err = lib.wkv_bwd_launch(
                    _DTYPE_CODE[r.dtype], _DTYPE_CODE[w.dtype],
                    *[ptr(x) for x in (r, k, v, w, dy, u, S0, dS_final, dr,
                                       dk, dv, dw, du, dS0, ckpt, sub)],
                    B, H, T, strides, stream)
            kernel = "wkv_bwd"
        if err != 0:
            msg = build.cuda_error_string(lib, err, kernel)
            raise RuntimeError(f"WKV backward kernel launch failed ({route} "
                               f"route): {msg}")
        wkv_bwd_bhtd.launches += 1
        wkv_bwd_bhtd.route_launches[route] += 1
        if route == "chunk":
            return dr, dk, dv, dw, du.view(B, H, -1, hd).sum((0, 2)), dS0
    return dr, dk, dv, dw, du.sum(0), dS0


#: Backward wrapper calls that launched (the chunked route's two kernels
#: count as one) since the last reset (set to 0 to start counting), and the
#: same split by route.
wkv_bwd_bhtd.launches = 0
wkv_bwd_bhtd.route_launches = {"chunk": 0, "step": 0}
