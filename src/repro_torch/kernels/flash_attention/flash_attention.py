"""Flash-attention forward: the hand-written CUDA kernel's wrapper.

:func:`flash_attention_bhtd` replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhtd``
(``_fa_kernel``).  The kernel is ``kernels/csrc/flash_attention.cu``, built
by :mod:`repro_torch.kernels.build` at first use; its source note says what
bounds it on an H100 and how it is laid out.  For tensors on the CPU the
wrapper computes the kernel's plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`; for CUDA
tensors it launches the kernel on the current stream without synchronising,
or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .ref import attention_ref

#: Head widths the kernel is instantiated for (qwen2's 64, qwen3's 128,
#: recurrentgemma's 256).
HEAD_DIMS = (64, 128, 256)


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu,
    ``smem_floats``): the q tile (64 x hd+1), a k tile (32 x hd+1), a v tile
    (32 x hd) and the probabilities (64 x 33), as float32."""
    return 4 * (64 * (hd + 1) + 32 * (hd + 1) + 32 * hd + 64 * 33)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    """Shapes, dtypes and devices every caller must meet."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_bhtd takes q [B,H,Tq,hd] and "
                         "k/v [B,Hkv,Tk,hd]")
    B, H, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention_bhtd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1] or k.shape[2] == 0:
        raise ValueError(f"flash_attention_bhtd: {H} query heads need a "
                         f"divisor count of key/value heads and Tk >= 1, "
                         f"got k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention_bhtd: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_bhtd: q, k, v on different devices")


def kernel_layout_ok(x) -> bool:
    """The kernels read 16-byte vectors along hd: hd contiguous, and every
    other stride and the base address 16-byte aligned."""
    es = x.element_size()
    return x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(
        (x.stride(i) * es) % 16 == 0 for i in range(3))


def _check_kernel_layout(name, x):
    if not kernel_layout_ok(x):
        raise ValueError(f"flash attention kernel: {name} needs a contiguous "
                         f"last dimension and 16-byte aligned strides, got "
                         f"strides {x.stride()}")


def flash_attention_bhtd(q, k, v, *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q [B,H,Tq,hd], k/v [B,Hkv,Tk,hd] -> o [B,H,Tq,hd] in q's dtype (and
    lse [B,H,Tq] float32 when ``return_lse``).  Any strides whose last one
    is 1: a ``transpose(1, 2)`` view of the model's [B,T,H,hd] tensors is
    read in place, and ``o`` is allocated with q's strides.

    CPU tensors: the plain version.  CUDA tensors: one launch of the kernel
    (float32 or bfloat16, hd 64, 128 or 256), or an exception."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention_bhtd is forward only; take "
                         "gradients through ops.flash_attention (the "
                         "FlashAttention autograd Function, whose backward "
                         "is flash_attention_bwd_bhtd)")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA (or, as its plain "
                         f"version, on the CPU), got {q.device}")
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_layout(name, x)
    o = torch.empty_like(q)
    _check_kernel_layout("o", o)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and Tq:
        from .. import build

        lib = build.load_flash_attention()
        strides = (ctypes.c_longlong * 12)(*[
            x.stride(i) for x in (q, k, v, o) for i in (0, 1, 2)])
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_launch(
                _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Hkv, Tq, Tk,
                strides, int(bool(causal)), int(window),
                float(1.0 / math.sqrt(hd)), stream)
        if err != 0:
            raise RuntimeError(
                f"flash attention kernel launch failed: "
                f"{build.cuda_error_string(lib, err, 'flash_attention')}")
        flash_attention_bhtd.launches += 1
    return (o, lse) if return_lse else o


#: Kernel launches since the last reset (set to 0 to start counting).
flash_attention_bhtd.launches = 0
