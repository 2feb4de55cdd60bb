"""RG-LRU scan: the hand-written CUDA kernel's wrapper.

:func:`rglru_scan` replaces the JAX package's Pallas TPU kernel
``repro/kernels/rglru/rglru.py::rglru_scan`` (``_rglru_kernel``).  The
kernel is ``kernels/csrc/rglru.cu``, built by :mod:`repro_torch.kernels.
build` at first use with ``-fmad=false``, so it equals its plain version
bit for bit; its source note says what bounds it on an H100.  For tensors
on the CPU the wrapper computes the plain version,
:func:`~repro_torch.kernels.rglru.ref.rglru_ref`; for CUDA tensors it
launches the kernel on the current stream without synchronising, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import rglru_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan(a, b):
    """a, b [B, T, C] -> h [B, T, C] in a's dtype, ``h_t = a_t h_{t-1} +
    b_t`` from zero.  Any strides whose channel one is 1; ``h`` is allocated
    with a's strides.

    CPU tensors: the plain version.  CUDA tensors: one launch of the kernel
    (float32 or bfloat16, a and b of one dtype), or an exception."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan takes a, b [B, T, C] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"rglru_scan: a and b differ in dtype or device "
                         f"({a.dtype}/{a.device}, {b.dtype}/{b.device})")
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the RG-LRU kernel runs on CUDA (or, as its plain "
                         f"version, on the CPU), got {a.device}")
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"the RG-LRU kernel takes float32 or bfloat16, got "
                         f"{a.dtype}")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError(f"RG-LRU kernel: a and b need a contiguous channel "
                         f"dimension, got strides {a.stride()}, {b.stride()}")
    B, T, C = a.shape
    h = torch.empty_like(a)
    if B and T and C:
        from .. import build

        lib = build.load_rglru()
        strides = (ctypes.c_longlong * 6)(*[
            x.stride(i) for x in (a, b, h) for i in (0, 1)])
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.rglru_launch(_DTYPE_CODE[a.dtype], a.data_ptr(),
                                   b.data_ptr(), h.data_ptr(), B, T, C,
                                   strides, stream)
        if err != 0:
            raise RuntimeError(
                f"RG-LRU kernel launch failed: "
                f"{build.cuda_error_string(lib, err, 'rglru')}")
        rglru_scan.launches += 1
    return h


#: Kernel launches since the last reset (set to 0 to start counting).
rglru_scan.launches = 0
