"""Flash-attention backward: the hand-written CUDA kernels' wrapper.

:func:`flash_attention_bwd_bhtd` replaces the JAX package's Pallas TPU
kernels ``repro/kernels/flash_attention/flash_attention_bwd.py::
flash_attention_bwd_bhtd`` (``_dq_kernel``, ``_dkdv_kernel``).  Two sources
compute it, chosen by the input type (:func:`~.flash_attention.route`):
bf16 goes to ``kernels/csrc/flash_attention_bwd_sm90.cu`` (``wgmma`` on
the tensor cores, tiles brought in by TMA), float32 to
``kernels/csrc/flash_attention_bwd.cu`` (float32 FMAs on register tiles,
tiles by cp.async).  Each is a dq kernel, then a dk/dv kernel that sums
each key/value head's group in float32 (the float32 ones, where they have
too few blocks to fill the card, in shares that a sum kernel adds in
order: :func:`f32_dq_split`, :func:`f32_kv_split`), built by :mod:`repro_torch.kernels.build` at first
use; the source notes say what bounds them on an H100 and how they are
laid out.
For tensors on the CPU the wrapper computes the plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`; for
CUDA tensors it launches the kernels on the current stream without
synchronising, or raises; for ``meta`` tensors it makes the outputs and
the scratch as on the card and launches nothing.  It is counted as kernel
3 (:mod:`repro_torch.kernels.cost`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import cost
from .flash_attention import (_check, _check_kernel_layout, _longlongs,
                              key_extent, route, shares, tma_geometry)
from .ref import attention_bwd_ref

#: Head widths the backward kernels are instantiated for (the dense
#: family's 64 and 128, recurrentgemma's 256).
HEAD_DIMS = (64, 128, 256)


#: The bf16 kernels' tiles: the dq kernel's query rows a block and key
#: rows a stage, the dk/dv kernel's key rows a block and query rows a stage
#: (csrc/flash_attention_bwd_sm90.cu, ``kQBQ``, ``kQBK``, ``kKBK``,
#: ``kKBQ``).
SM90_DQ_BQ, SM90_DQ_BK, SM90_KV_BK, SM90_KV_BQ = 128, 64, 128, 64


def sm90_smem_bytes(hd: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the bf16 dq and dk/dv kernels
    (``Bwd<HD>::kDqSmem`` / ``kKvSmem``): dq holds the Q and dO tiles and
    its stages of K and V tiles; dk/dv the K and V tiles, its stages of Q
    and dO tiles and of the tile's lse and delta (float32); 2 stages at hd
    64 and 128, 1 at 256; each with 1,024 bytes to align the base for the
    128-byte swizzle."""
    stages = 1 if hd > 128 else 2
    return (2 * hd * (2 * SM90_DQ_BQ + 2 * stages * SM90_DQ_BK) + 1024,
            2 * hd * (2 * SM90_KV_BK + 2 * stages * SM90_KV_BQ)
            + 8 * stages * SM90_KV_BQ + 1024)


#: The float32 kernels' threads and tiles by head width
#: (csrc/flash_attention_bwd.cu, ``Dq<HD>``, ``Dkv<HD>``): the dq kernel's
#: threads, query rows a block and keys a stage; the dk/dv kernel's
#: threads and query rows a stage (its blocks hold 64 keys).
F32_DQ_THREADS = {64: 128, 128: 256, 256: 256}
F32_DQ_BQ = {64: 128, 128: 128, 256: 64}
F32_DQ_BK = {64: 32, 128: 32, 256: 16}
F32_KV_THREADS = {64: 128, 128: 256, 256: 256}
F32_KV_BQ = {64: 32, 128: 64, 256: 16}
F32_KV_BK = 64


def smem_bytes(hd: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the float32 dq and dk/dv
    kernels (csrc/flash_attention_bwd.cu, ``Dq<HD>::kSmem`` /
    ``Dkv<HD>::kSmem``), as float32: dq holds the Q and dO tiles (BQ x
    hd), its ring's two stages of K and V (BK x hd each) and ds (BK x BQ);
    dk/dv holds the K and V tiles (64 x hd), its ring's two stages of Q and
    dO (BQ x hd each), p and ds (BQ x 64)."""
    bq, bk, kq = F32_DQ_BQ[hd], F32_DQ_BK[hd], F32_KV_BQ[hd]
    return (4 * (2 * bq * hd + 4 * bk * hd + bk * bq),
            4 * (2 * F32_KV_BK * hd + 4 * kq * hd + 2 * kq * F32_KV_BK))


def f32_kv_split(B: int, H: int, Hkv: int, Tq: int, Tk: int, hd: int,
                 n_sms: int) -> int:
    """Shares of the float32 dk/dv kernel (:func:`~.flash_attention.shares`):
    its blocks are the key tiles x key/value heads x batch rows, two an SM
    at hd 64, else one (``n_sms`` SMs); each key tile's (query head, query
    tile) items are cut, and a sum kernel adds the shares.  The most items
    are key tile 0's, every query tile's under the causal mask at any query
    offset (query row i sits at ``q_offset + i`` >= 0), so the plan does
    not depend on the offset."""
    return shares(-(-Tk // F32_KV_BK) * Hkv * B,
                  n_sms * (2 if hd == 64 else 1),
                  (H // Hkv) * -(-Tq // F32_KV_BQ[hd]))


def f32_dq_split(B: int, H: int, Tq: int, Tk: int, hd: int, n_sms: int,
                 causal: bool = True, q_offset: int = 0) -> int:
    """Shares of the float32 dq kernel (:func:`~.flash_attention.shares`):
    its blocks are the query tiles x query heads x batch rows, two an SM at
    hd 64, else one; each query tile's key tiles are cut (the longest loop
    :func:`~.flash_attention.key_extent`'s keys), and a sum kernel adds
    the shares."""
    return shares(-(-Tq // F32_DQ_BQ[hd]) * H * B,
                  n_sms * (2 if hd == 64 else 1),
                  -(-key_extent(Tq, Tk, causal, q_offset) // F32_DQ_BK[hd]))


def _bwd_cost(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    B, H, Tq, hd = q.shape
    return cost.flash_bwd(B, H, k.shape[1], hd, Tq, k.shape[2], causal,
                          q.element_size(), window, q_offset)


@cost.counted("flash_attention_bwd_bhtd", _bwd_cost)
def flash_attention_bwd_bhtd(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0):
    """Gradients of :func:`flash_attention_bhtd` from its saved output ``o``
    and ``lse``.  q, o, do [B,H,Tq,hd]; k/v [B,Hkv,Tk,hd]; lse [B,H,Tq]
    float32.  Returns (dq [B,H,Tq,hd], dk, dv [B,Hkv,Tk,hd]) in the inputs'
    dtype, each allocated with its input's strides (a ``transpose(1, 2)``
    view of the model's [B,T,H,hd] tensors is read and written in place).
    Query row i sits at position ``q_offset + i`` (the forward's); a key
    no query reaches gets zero dk and dv.

    CPU tensors: the plain version.  CUDA tensors: one launch of each of
    the two bf16 (``wgmma``) or float32 (FMA; and the shares' sums where
    :func:`f32_dq_split` or :func:`f32_kv_split` cut the work) kernels,
    hd 64, 128 or 256,
    or an exception.  Meta tensors: the outputs and scratch, no launch."""
    _check(q, k, v)
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd_bhtd: {name} "
                             f"{tuple(x.shape)} {x.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_bhtd: lse must be float32 "
                         f"[B,H,Tq] = {(B, H, Tq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        grads = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                  window=window, q_offset=q_offset)
        return tuple(cost.strided_like(g, x) for g, x in zip(grads,
                                                             (q, k, v)))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on CUDA (or, as its plain "
                         f"version, on the CPU), got {q.device}")
    kernel = route(q.dtype, hd, HEAD_DIMS)
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_kernel_layout(name, x)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for name, x in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check_kernel_layout(name, x)
    # lse and delta = rowsum(dO o o) in float32, delta as one PyTorch
    # expression, as JAX computes it outside Pallas
    # (flash_attention_bwd.py:144).  The bf16 kernels read both by TMA,
    # whose rows must be 16-byte multiples: [B, H, pitch], pitch = Tq
    # rounded up to 4.
    # The float32 kernels read both as contiguous [B, H, Tq]: lse as it is,
    # delta summed straight into its buffer.
    if kernel == "fma":
        pitch, lse_p = Tq, lse.contiguous()
        delta = torch.sum(do * o, -1, out=lse.new_empty((B, H, Tq)))
    else:
        pitch = -(-Tq // 4) * 4
        lse_p = lse.new_empty((B, H, pitch))
        lse_p[..., :Tq] = lse
        delta = lse.new_empty((B, H, pitch))
        delta[..., :Tq] = (do.float() * o.float()).sum(-1)
    # The float32 kernels' shares and their scratch (f32_kv_split,
    # f32_dq_split).
    split, part, dq_split, dq_part = 1, None, 1, None
    if kernel == "fma":
        n_sms = cost.sm_count(q.device)
        split = f32_kv_split(B, H, k.shape[1], Tq, Tk, hd, n_sms)
        if split > 1:
            part = lse.new_empty((2, split, B, k.shape[1], Tk, hd))
        dq_split = f32_dq_split(B, H, Tq, Tk, hd, n_sms, causal, q_offset)
        if dq_split > 1:
            dq_part = lse.new_empty((dq_split, B, H, Tq, hd))
    if q.device.type == "meta":
        return dq, dk, dv
    if B and Tq and Tk:
        from .. import build

        scale = float(1.0 / math.sqrt(hd))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            if kernel == "wgmma":
                lib = build.load_flash_attention_bwd_sm90()
                geom = []
                for rows_q, rows_k in ((SM90_DQ_BQ, SM90_DQ_BK),
                                       (SM90_KV_BQ, SM90_KV_BK)):
                    geom += (tma_geometry(q, rows_q) + tma_geometry(k, rows_k)
                             + tma_geometry(v, rows_k)
                             + tma_geometry(do, rows_q))
                err = lib.flash_attention_bwd_sm90_launch(
                    hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse_p.data_ptr(), delta.data_ptr(), pitch,
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                    k.shape[1], Tq, Tk, _longlongs(geom),
                    _longlongs([x.stride(i) for x in (dq, dk, dv)
                                for i in (0, 1, 2)]),
                    int(bool(causal)), int(window), scale, int(q_offset),
                    stream)
                name = "flash_attention_bwd_sm90"
            else:
                lib = build.load_flash_attention_bwd()
                strides = _longlongs([x.stride(i) for x in
                                      (q, k, v, do, dq, dk, dv)
                                      for i in (0, 1, 2)])
                err = lib.flash_attention_bwd_launch(
                    hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse_p.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                    k.shape[1], Tq, Tk, strides, int(bool(causal)),
                    int(window), scale, split,
                    None if part is None else part.data_ptr(), dq_split,
                    None if dq_part is None else dq_part.data_ptr(),
                    int(q_offset), stream)
                name = "flash_attention_bwd"
        if err != 0:
            raise RuntimeError(
                f"flash attention backward kernel launch failed: "
                f"{build.cuda_error_string(lib, err, name)}")
        flash_attention_bwd_bhtd.launches += 1
        flash_attention_bwd_bhtd.route_launches[kernel] += 1
    else:
        for x in (dq, dk, dv):
            x.zero_()
    return dq, dk, dv


#: Kernel launches since the last reset (set to 0 to start counting), and
#: the same split by route ("wgmma": bf16, "fma": float32).
flash_attention_bwd_bhtd.launches = 0
flash_attention_bwd_bhtd.route_launches = {"wgmma": 0, "fma": 0}
