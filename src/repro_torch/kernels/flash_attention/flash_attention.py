"""Flash-attention forward: the hand-written CUDA kernels' wrapper.

:func:`flash_attention_bhtd` replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhtd``
(``_fa_kernel``).  Two kernels compute it, chosen by the input type
(:func:`route`): bf16 goes to ``kernels/csrc/flash_attention_sm90.cu``
(``wgmma`` on the tensor cores, tiles brought in by TMA), float32 to
``kernels/csrc/flash_attention.cu`` (float32 FMAs: ``wgmma`` would round
float32 to TF32).  Both are built by :mod:`repro_torch.kernels.build` at
first use; their source notes say what bounds them on an H100 and how
they are laid out.  For tensors on the CPU the wrapper computes the
kernels' plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`; for CUDA
tensors it launches one kernel on the current stream without
synchronising, or raises.
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
    """Dynamic shared memory of one block of the float32 kernel
    (csrc/flash_attention.cu, ``smem_floats``): the q tile (64 x hd+1), a k
    tile (32 x hd+1), a v tile (32 x hd) and the probabilities (64 x 33),
    as float32."""
    return 4 * (64 * (hd + 1) + 32 * (hd + 1) + 32 * hd + 64 * 33)


#: The bf16 kernel's query rows a block (two warpgroups of 64).
SM90_BQ = 128


def sm90_bk(hd: int) -> int:
    """Key rows of one stage of the bf16 kernel (``Fwd<HD>::kBK``)."""
    return 64 if hd == 256 else 128


def sm90_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block of the bf16 kernel
    (csrc/flash_attention_sm90.cu, ``Fwd<HD>::kSmem``): the bf16 Q tile, 2
    stages of K and V tiles, and 1,024 bytes to align the base for the
    128-byte swizzle."""
    return 2 * hd * (SM90_BQ + 4 * sm90_bk(hd)) + 1024


def route(dtype, hd: int, head_dims=HEAD_DIMS) -> str:
    """Which kernel takes inputs of ``dtype`` and head width ``hd``:
    ``"wgmma"`` (bf16) or ``"fma"`` (float32).  A choice by input type, made
    on the host: a kernel that fails still raises."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the flash attention kernels take float32 or "
                         f"bfloat16, got {dtype}")
    if hd not in head_dims:
        raise ValueError(f"the flash attention kernels take hd in "
                         f"{head_dims}, got {hd}")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def tma_geometry(x, box_rows: int) -> list[int]:
    """The TMA tensor map the bf16 kernels build over a [B, N, T, hd] view
    (the kernel layout; N heads), as 9 integers: dims (hd, T, N, B), the
    byte strides of T, N and B, and the box (64 columns x ``box_rows``
    rows).  The map's T is the view's own, so a ``cache[:, :Tk]`` slice
    ends at Tk and TMA reads zeros past it.  Raises for a layout TMA
    cannot address (see :func:`kernel_layout_ok`)."""
    _check_kernel_layout("a TMA operand", x)
    B, N, T, hd = x.shape
    es = x.element_size()
    return [hd, T, N, B, x.stride(2) * es, x.stride(1) * es,
            x.stride(0) * es, 64, box_rows]


def _longlongs(values):
    return (ctypes.c_longlong * len(values))(*values)


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

    CPU tensors: the plain version.  CUDA tensors: one launch of the bf16
    (``wgmma``) or the float32 (FMA) kernel, hd 64, 128 or 256, or an
    exception."""
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
    kernel = route(q.dtype, hd)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_layout(name, x)
    o = torch.empty_like(q)
    _check_kernel_layout("o", o)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and Tq:
        from .. import build

        scale = float(1.0 / math.sqrt(hd))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            lse_ptr = None if lse is None else lse.data_ptr()
            if kernel == "wgmma":
                lib = build.load_flash_attention_sm90()
                bk = sm90_bk(hd)
                geom = _longlongs(tma_geometry(q, SM90_BQ)
                                  + tma_geometry(k, bk) + tma_geometry(v, bk))
                err = lib.flash_attention_sm90_launch(
                    hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse_ptr, B, H, Hkv, Tq, Tk, geom,
                    _longlongs([o.stride(i) for i in (0, 1, 2)]),
                    int(bool(causal)), int(window), scale, stream)
                name = "flash_attention_sm90"
            else:
                lib = build.load_flash_attention()
                strides = _longlongs([x.stride(i) for x in (q, k, v, o)
                                      for i in (0, 1, 2)])
                err = lib.flash_attention_launch(
                    hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse_ptr, B, H, Hkv, Tq, Tk, strides,
                    int(bool(causal)), int(window), scale, stream)
                name = "flash_attention"
        if err != 0:
            raise RuntimeError(
                f"flash attention kernel launch failed: "
                f"{build.cuda_error_string(lib, err, name)}")
        flash_attention_bhtd.launches += 1
        flash_attention_bhtd.route_launches[kernel] += 1
    return (o, lse) if return_lse else o


#: Kernel launches since the last reset (set to 0 to start counting), and
#: the same split by route ("wgmma": bf16, "fma": float32).
flash_attention_bhtd.launches = 0
flash_attention_bhtd.route_launches = {"wgmma": 0, "fma": 0}
