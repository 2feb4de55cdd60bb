"""Flash-attention backward: the hand-written CUDA kernels' wrapper.

:func:`flash_attention_bwd_bhtd` replaces the JAX package's Pallas TPU
kernels ``repro/kernels/flash_attention/flash_attention_bwd.py::
flash_attention_bwd_bhtd`` (``_dq_kernel``, ``_dkdv_kernel``).  Two sources
compute it, chosen by the input type (:func:`~.flash_attention.route`):
bf16 goes to ``kernels/csrc/flash_attention_bwd_sm90.cu`` (``wgmma`` on
the tensor cores, tiles brought in by TMA), float32 to
``kernels/csrc/flash_attention_bwd.cu`` (float32 FMAs).  Each is a dq
kernel, then a dk/dv kernel that sums each key/value head's group in
float32, built by :mod:`repro_torch.kernels.build` at first use; the
source notes say what bounds them on an H100 and how they are laid out.
For tensors on the CPU the wrapper computes the plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`; for
CUDA tensors it launches the kernels on the current stream without
synchronising, or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import (_check, _check_kernel_layout, _longlongs, route,
                              tma_geometry)
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


def smem_bytes(hd: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the float32 dq and dk/dv
    kernels (csrc/flash_attention_bwd.cu, ``dq_smem_floats`` /
    ``dkdv_smem_floats``), as float32: dq holds q and dO tiles (64 x
    hd+1), k and v tiles (32 x hd+1) and ds (64 x 33); dk/dv holds k and v
    (32 x hd+1), q and dO (64 x hd+1), p^T and ds^T (32 x 65) and 2 x 64
    row scalars."""
    return (4 * (2 * 64 * (hd + 1) + 2 * 32 * (hd + 1) + 64 * 33),
            4 * (2 * 32 * (hd + 1) + 2 * 64 * (hd + 1) + 2 * 32 * 65
                 + 2 * 64))


def flash_attention_bwd_bhtd(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0):
    """Gradients of :func:`flash_attention_bhtd` from its saved output ``o``
    and ``lse``.  q, o, do [B,H,Tq,hd]; k/v [B,Hkv,Tk,hd]; lse [B,H,Tq]
    float32.  Returns (dq [B,H,Tq,hd], dk, dv [B,Hkv,Tk,hd]) in the inputs'
    dtype, each allocated with its input's strides (a ``transpose(1, 2)``
    view of the model's [B,T,H,hd] tensors is read and written in place).

    CPU tensors: the plain version.  CUDA tensors: one launch of each of
    the two bf16 (``wgmma``) or float32 (FMA) kernels, hd 64, 128 or 256,
    or an exception."""
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
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    if q.device.type != "cuda":
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
    pitch = Tq if kernel == "fma" else -(-Tq // 4) * 4
    lse_p = lse.new_empty((B, H, pitch))
    lse_p[..., :Tq] = lse
    delta = lse.new_empty((B, H, pitch))
    delta[..., :Tq] = (do.float() * o.float()).sum(-1)
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
                    int(bool(causal)), int(window), scale, stream)
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
                    int(window), scale, stream)
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
