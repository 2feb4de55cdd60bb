"""RG-LRU scan: the hand-written CUDA kernels' wrappers.

:func:`rglru_scan` replaces the JAX package's Pallas TPU kernel
``repro/kernels/rglru/rglru.py::rglru_scan`` (``_rglru_kernel``);
:func:`rglru_scan_bwd` is its backward, the port's own (JAX differentiates
its associative scan in XLA).  Both kernels are ``kernels/csrc/rglru.cu``,
built by :mod:`repro_torch.kernels.build` at first use with
``-fmad=false``, so each equals its plain version bit for bit; the source
note says what bounds them on an H100.  For tensors on the CPU a wrapper
computes the plain version (:func:`~repro_torch.kernels.rglru.ref.
rglru_ref`, :func:`~repro_torch.kernels.rglru.ref.rglru_bwd_ref`); for
CUDA tensors it launches its kernel on the current stream without
synchronising, or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import rglru_bwd_ref, rglru_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_inputs(name, xs):
    """The kernels take CUDA tensors of one float32 or bfloat16 dtype with
    a contiguous channel dimension."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"the RG-LRU kernels run on CUDA (or, as their "
                         f"plain versions, on the CPU), got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the RG-LRU kernels take float32 or bfloat16, got "
                         f"{x.dtype}")
    if any(y.stride(2) != 1 for y in xs):
        raise ValueError(f"RG-LRU kernel: {name} need a contiguous channel "
                         f"dimension, got strides "
                         f"{[y.stride() for y in xs]}")


def _strides(x):
    """(batch, time) element strides of [B, T, C] ``x``, the batch one made
    T x time for B = 1 (never read, so any value serves, and TMA takes
    this one)."""
    B, T, _ = x.shape
    return (T * x.stride(1) if B == 1 else x.stride(0)), x.stride(1)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(xs, n_sms: int) -> tuple[int, bool]:
    """(channels a block, TMA or not) for the [B, T, C] operands ``xs`` of
    one launch: 32 channels when B x C / 32 one-warp blocks give every SM
    one, else 16; TMA when it can address every operand (T > 1; base
    addresses and batch and time strides 16-byte aligned, each in its own
    element size; rows that do not overlap)."""
    B, T, C = xs[0].shape
    width = 32 if B * -(-C // 32) >= n_sms else 16

    def addressable(x):
        sb, st = _strides(x)
        es = x.element_size()
        return (x.data_ptr() % 16 == 0 and (sb * es) % 16 == 0
                and (st * es) % 16 == 0 and st >= C and sb >= T * st)

    return width, T > 1 and all(addressable(x) for x in xs)


def kernel_plan(a, b, h, n_sms: int) -> tuple[int, bool]:
    """(channels a block, TMA or not) of the forward kernel for a, b and
    its output h [B, T, C] on a card of ``n_sms`` SMs.  A block is one warp
    over 16 or 32 channels of one row: 32 when B x C / 32 blocks give every
    SM one, else 16.  a and b stream in and h out by TMA when TMA can
    address all three (T > 1; base addresses and batch and time strides
    16-byte aligned; rows that do not overlap); otherwise the kernel reads
    and writes them directly, with the same result."""
    return _plan((a, b, h), n_sms)


def bwd_plan(a, h, g, da, db, n_sms: int) -> tuple[int, bool]:
    """(channels a block, TMA or not) of the backward kernel for a, h, g
    and its float32 outputs da, db [B, T, C]: the forward's rule over the
    five operands.  Where TMA cannot address one of them (T = 1, a
    misaligned base or stride, overlapping rows) each lane walks its
    channel straight from device memory, with the same result."""
    return _plan((a, h, g, da, db), n_sms)


def rglru_scan(a, b):
    """a, b [B, T, C] -> h [B, T, C] in a's dtype, ``h_t = a_t h_{t-1} +
    b_t`` from zero.  Any strides whose channel one is 1; ``h`` is allocated
    with a's strides.

    CPU tensors: the plain version.  CUDA tensors: one launch of the kernel
    (float32 or bfloat16, a and b of one dtype; its path by
    :func:`kernel_plan`), or an exception."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan takes a, b [B, T, C] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"rglru_scan: a and b differ in dtype or device "
                         f"({a.dtype}/{a.device}, {b.dtype}/{b.device})")
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    _check_kernel_inputs("a and b", (a, b))
    B, T, C = a.shape
    h = torch.empty_like(a)
    if B and T and C:
        from .. import build

        lib = build.load_rglru()
        width, tma = kernel_plan(a, b, h, _sm_count(a.device))
        strides = (ctypes.c_longlong * 6)(*[
            s for x in (a, b, h) for s in _strides(x)])
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.rglru_launch(_DTYPE_CODE[a.dtype], a.data_ptr(),
                                   b.data_ptr(), h.data_ptr(), B, T, C,
                                   strides, width, int(tma), stream)
        if err != 0:
            raise RuntimeError(
                f"RG-LRU kernel launch failed: "
                f"{build.cuda_error_string(lib, err, 'rglru')}")
        rglru_scan.launches += 1
    return h


#: Kernel launches since the last reset (set to 0 to start counting).
rglru_scan.launches = 0


def rglru_scan_bwd(a, h, g):
    """(da, db) [B, T, C] float32: the gradients of ``h = rglru_scan(a, b)``
    for the output gradient ``g``, from the forward's ``h`` (a, h, g of one
    shape and dtype; any strides whose channel one is 1).

    CPU tensors: the plain version.  CUDA tensors: one launch of the
    backward kernel (its path by :func:`bwd_plan`), or an exception."""
    if a.dim() != 3 or not a.shape == h.shape == g.shape:
        raise ValueError(f"rglru_scan_bwd takes a, h, g [B, T, C] of one "
                         f"shape, got {tuple(a.shape)}, {tuple(h.shape)}, "
                         f"{tuple(g.shape)}")
    if len({(x.dtype, x.device) for x in (a, h, g)}) != 1:
        raise ValueError(f"rglru_scan_bwd: a, h and g differ in dtype or "
                         f"device ({[(x.dtype, x.device) for x in (a, h, g)]})")
    if a.device.type == "cpu":
        return rglru_bwd_ref(a, h, g)
    _check_kernel_inputs("a, h and g", (a, h, g))
    B, T, C = a.shape
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    if B and T and C:
        from .. import build

        lib = build.load_rglru()
        width, tma = bwd_plan(a, h, g, da, db, _sm_count(a.device))
        strides = (ctypes.c_longlong * 10)(*[
            s for x in (a, h, g, da, db) for s in _strides(x)])
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.rglru_bwd_launch(_DTYPE_CODE[a.dtype], a.data_ptr(),
                                       h.data_ptr(), g.data_ptr(),
                                       da.data_ptr(), db.data_ptr(), B, T, C,
                                       strides, width, int(tma), stream)
        if err != 0:
            raise RuntimeError(
                f"RG-LRU backward kernel launch failed: "
                f"{build.cuda_error_string(lib, err, 'rglru')}")
        rglru_scan_bwd.launches += 1
    return da, db


#: Backward kernel launches since the last reset (set to 0 to start
#: counting).
rglru_scan_bwd.launches = 0
