"""Flash-attention forward: the hand-written CUDA kernels' wrapper.

:func:`flash_attention_bhtd` replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhtd``
(``_fa_kernel``).  Two kernels compute it, chosen by the input type
(:func:`route`): bf16 goes to ``kernels/csrc/flash_attention_sm90.cu``
(``wgmma`` on the tensor cores, tiles brought in by TMA), float32 to
``kernels/csrc/flash_attention.cu`` (float32 FMAs on 8 x 8 register
tiles, K and V by cp.async: ``wgmma`` would round float32 to TF32).  Both are built by :mod:`repro_torch.kernels.build` at
first use; their source notes say what bounds them on an H100 and how
they are laid out.  For tensors on the CPU the wrapper computes the
kernels' plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`; for CUDA
tensors it launches one kernel on the current stream without
synchronising, or raises; for ``meta`` tensors (the dry run) it returns
the outputs' shapes and types and launches nothing.  A step counter
active around a call counts the kernel's operations and bytes
(:mod:`repro_torch.kernels.cost`) on every device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import cost
from .ref import attention_ref

#: Head widths the kernel is instantiated for (qwen2's 64, qwen3's 128,
#: recurrentgemma's 256).
HEAD_DIMS = (64, 128, 256)


#: The float32 kernel's threads and query rows a block by head width
#: (csrc/flash_attention.cu, ``Fwd<HD>``); its key tiles are 64 rows.
F32_THREADS = {64: 128, 128: 128, 256: 256}
F32_BQ = {64: 128, 128: 64, 256: 64}
F32_BK = 64


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block of the float32 kernel
    (csrc/flash_attention.cu, ``Fwd<HD>::kSmem``), as float32: the Q tile
    (BQ x hd), the ring's two stages (a K and a V tile, 64 x hd each), p^T
    (64 x BQ) and two floats a query row (its rescale and its
    denominator); BQ is :data:`F32_BQ`."""
    bq = F32_BQ[hd]
    return 4 * (bq * hd + 2 * F32_BK * hd + F32_BK * bq + 2 * bq)


def shares(blocks: int, slots: int, most: int) -> int:
    """Into how many shares a float32 kernel cuts each block's loop: where
    its ``blocks`` fill less than one wave of the card's block ``slots``,
    ceil(2 slots / blocks), at most ``most`` (the longest loop); else 1.
    Each share's float32 sums go to a scratch that one more pass adds in a
    fixed order, so a causal mask's long and short loops even out.  (From
    one wave on, a second share cost more than it evened out: qwen3's
    16/8 heads at B 1 x T 2,048, PERF.md.)"""
    if blocks >= slots:
        return 1
    return max(1, min(-(-2 * slots // blocks), most))


def key_extent(Tq: int, Tk: int, causal: bool = True,
               q_offset: int = 0) -> int:
    """Keys the longest query tile's loop covers: under the causal mask the
    last query's position + 1 (query row i at ``q_offset + i``), at most
    Tk; Tk without it.  The float32 kernels run their query tiles longest
    first, and their shares cut loops of at most this many keys."""
    return min(Tk, q_offset + Tq) if causal else Tk


def f32_split(B: int, H: int, Tq: int, Tk: int, hd: int, n_sms: int,
              causal: bool = True, q_offset: int = 0) -> int:
    """Shares of the float32 forward (:func:`shares`): its blocks are the
    query tiles x heads x batch rows, two an SM at hd 64 and 128, one at
    256 (``n_sms`` SMs); each query tile's key tiles are cut, the longest
    loop being :func:`key_extent`'s keys."""
    return shares(-(-Tq // F32_BQ[hd]) * H * B,
                  n_sms * (1 if hd == 256 else 2),
                  -(-key_extent(Tq, Tk, causal, q_offset) // F32_BK))


#: An H100 SM's shared memory, the part of it each resident block
#: reserves, its registers and the most a lane may hold.
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1024
SM_REGISTERS, MAX_LANE_REGISTERS = 65_536, 255


def resident_warps(smem: int, threads: int) -> int:
    """Warps one H100 SM holds at once of a kernel whose blocks have
    ``threads`` threads and ``smem`` bytes of dynamic shared memory: as many
    blocks as shared memory (with each block's 1,024 reserved bytes) and
    registers at the most a lane may hold (255) allow."""
    blocks = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES),
                 SM_REGISTERS // (threads * MAX_LANE_REGISTERS))
    return blocks * threads // 32


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
    ``"wgmma"`` (bf16: tensor cores, tiles by TMA) or ``"fma"`` (float32:
    float32 FMAs on register tiles, tiles by cp.async; wgmma would round
    float32 to TF32).  A choice by input type, made on the host: a kernel
    that fails still raises."""
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


def _fwd_cost(q, k, v, *, causal: bool = True, window: int = 0,
              return_lse: bool = False, q_offset: int = 0):
    B, H, Tq, hd = q.shape
    return cost.flash_fwd(B, H, k.shape[1], hd, Tq, k.shape[2], causal,
                          q.element_size(), window, q_offset)


@cost.counted("flash_attention_bhtd", _fwd_cost)
def flash_attention_bhtd(q, k, v, *, causal: bool = True, window: int = 0,
                         return_lse: bool = False, q_offset: int = 0):
    """q [B,H,Tq,hd], k/v [B,Hkv,Tk,hd] -> o [B,H,Tq,hd] in q's dtype (and
    lse [B,H,Tq] float32 when ``return_lse``).  Any strides whose last one
    is 1: a ``transpose(1, 2)`` view of the model's [B,T,H,hd] tensors is
    read in place, and ``o`` is allocated with q's strides.  Query row i
    sits at position ``q_offset + i`` and key j at j (:func:`~.ref.
    attention_ref`'s positions; a rank's block of the queries under
    context parallelism).

    CPU tensors: the plain version.  CUDA tensors: one launch of the bf16
    (``wgmma``) or the float32 (FMA) kernel (and the shares' combine where
    :func:`f32_split` cuts its key loops), hd 64, 128 or 256, or an
    exception.  Meta tensors: the empty outputs (and scratch), no launch."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention_bhtd is forward only; take "
                         "gradients through ops.flash_attention (the "
                         "FlashAttention autograd Function, whose backward "
                         "is flash_attention_bwd_bhtd)")
    if q_offset < 0:
        raise ValueError(f"flash_attention_bhtd: q_offset {q_offset} < 0")
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, window=window,
                            return_lse=return_lse, q_offset=q_offset)
        if return_lse:
            return cost.strided_like(out[0], q), out[1]
        return cost.strided_like(out, q)
    if q.device.type not in ("cuda", "meta"):
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
    # The float32 kernel's shares and their scratch (f32_split).
    split, part = 1, None
    if kernel == "fma":
        split = f32_split(B, H, Tq, Tk, hd, cost.sm_count(q.device),
                          causal, q_offset)
        if split > 1:
            part = torch.empty(split * B * H * Tq * (hd + 2),
                               dtype=torch.float32, device=q.device)
    if B and Tq and q.device.type == "cuda":
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
                    int(bool(causal)), int(window), scale, int(q_offset),
                    stream)
                name = "flash_attention_sm90"
            else:
                lib = build.load_flash_attention()
                strides = _longlongs([x.stride(i) for x in (q, k, v, o)
                                      for i in (0, 1, 2)])
                err = lib.flash_attention_launch(
                    hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse_ptr, B, H, Hkv, Tq, Tk, strides,
                    int(bool(causal)), int(window), scale, split,
                    None if part is None else part.data_ptr(), int(q_offset),
                    stream)
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
