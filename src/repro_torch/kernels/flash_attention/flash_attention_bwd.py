"""Flash-attention backward: the hand-written CUDA kernel's wrapper.

:func:`flash_attention_bwd_bhtd` replaces the JAX package's Pallas TPU
kernels ``repro/kernels/flash_attention/flash_attention_bwd.py::
flash_attention_bwd_bhtd`` (``_dq_kernel``, ``_dkdv_kernel``).  The kernels
are ``kernels/csrc/flash_attention_bwd.cu`` (a dq kernel, then a dk/dv
kernel that sums each key/value head's group in float32), built by
:mod:`repro_torch.kernels.build` at first use; the source note says what
bounds them on an H100 and how they are laid out.  For tensors on the CPU
the wrapper computes the plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`; for
CUDA tensors it launches the kernels on the current stream without
synchronising, or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import _DTYPE_CODE, _check, _check_kernel_layout
from .ref import attention_bwd_ref

#: Head widths the backward kernels are instantiated for (the dense
#: family's; the recurrent families do not train yet).
HEAD_DIMS = (64, 128)


def smem_bytes(hd: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the dq and of the dk/dv kernel
    (csrc/flash_attention_bwd.cu, ``dq_smem_floats`` / ``dkdv_smem_floats``),
    as float32: dq holds q and dO tiles (64 x hd+1), k and v tiles (32 x
    hd+1) and ds (64 x 33); dk/dv holds k and v (32 x hd+1), q and dO
    (64 x hd+1), p^T and ds^T (32 x 65) and 2 x 64 row scalars."""
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

    CPU tensors: the plain version.  CUDA tensors: one launch of each
    kernel (float32 or bfloat16, hd 64 or 128), or an exception."""
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
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_kernel_layout(name, x)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for name, x in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check_kernel_layout(name, x)
    lse = lse.contiguous()
    # delta = rowsum(dO o o) in float32: one PyTorch expression, as JAX
    # computes it outside Pallas (flash_attention_bwd.py:144)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    if B and Tq and Tk:
        from .. import build

        lib = build.load_flash_attention_bwd()
        strides = (ctypes.c_longlong * 21)(*[
            x.stride(i) for x in (q, k, v, do, dq, dk, dv) for i in (0, 1, 2)])
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_bwd_launch(
                _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, H, k.shape[1], Tq, Tk, strides,
                int(bool(causal)), int(window), float(1.0 / math.sqrt(hd)),
                stream)
        if err != 0:
            raise RuntimeError(
                f"flash attention backward kernel launch failed: "
                f"{build.cuda_error_string(lib, err, 'flash_attention_bwd')}")
        flash_attention_bwd_bhtd.launches += 1
    else:
        for x in (dq, dk, dv):
            x.zero_()
    return dq, dk, dv


#: Kernel launches since the last reset (set to 0 to start counting).
flash_attention_bwd_bhtd.launches = 0
