"""What each hand-written kernel costs: its operations and bytes, from the
shapes and types of one call, and the hook that reports them to a step
counter (``repro_torch.launch.hlo_stats.StepCounter``).

The formulas are the bound column of the kernel table (``chip_smoke.py``
divides them by the card's peaks): operations are the kernel's own
products and recurrences, 2 a multiply-add; bytes count each input read
once and each output written once.  A PyTorch op counter cannot see into
a kernel (``torch.utils.flop_counter`` knows matrix products and
convolutions only), and on the CPU a wrapper runs the kernel's plain
version instead, whose PyTorch ops are not what the card does.  So each
wrapper is :func:`counted`: while a counter is active, a call reports the
kernel's formula once, on ``cuda``, ``meta`` and ``cpu`` alike, and the
counter leaves the operations and bytes of the PyTorch ops inside the call
out (their memory it still tracks).  With no counter active a call costs
one list test.
"""
from __future__ import annotations

import contextlib
import functools

#: SMs of the H100 SXM: the kernels' launch plans read the card's own
#: count; a call on ``meta`` plans as on this card.
H100_SMS = 132

#: The active counters, innermost last (``StepCounter`` enters and leaves).
_COUNTERS: list = []


@contextlib.contextmanager
def active(counter):
    """Report the kernels called while entered to ``counter`` (an object
    with ``enter_kernel(name, flops, nbytes)`` and ``exit_kernel()``)."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def counted(name: str, formula):
    """Decorate a kernel wrapper: with a counter active, a call reports
    ``formula(*args, **kwargs)`` = (operations, bytes) under ``name`` and
    runs inside the counter's kernel region."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _COUNTERS:
                return fn(*args, **kwargs)
            flops, nbytes = formula(*args, **kwargs)
            counters = list(_COUNTERS)
            for c in counters:
                c.enter_kernel(name, flops, nbytes)
            try:
                return fn(*args, **kwargs)
            finally:
                for c in counters:
                    c.exit_kernel()
        return run
    return deco


def strided_like(x, template):
    """``x`` (a plain version's output) with ``template``'s strides, as the
    kernel allocates its output (``torch.empty_like``): the ops after a
    call then see one layout, and count alike, on every device."""
    import torch

    if x.stride() == template.stride():
        return x
    return torch.empty_strided(template.shape, template.stride(),
                               dtype=x.dtype, device=x.device).copy_(x)


def sm_count(device) -> int:
    """The SMs a launch plan divides work over: the card's own, or
    :data:`H100_SMS` on ``meta``."""
    import torch

    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


# ------------------------------------------------------------ formulas ---

def _reach(n: int, Tk: int) -> int:
    """sum of min(j, Tk) for j = 1 .. n (0 for n <= 0)."""
    if n <= 0:
        return 0
    if n <= Tk:
        return n * (n + 1) // 2
    return Tk * (Tk + 1) // 2 + (n - Tk) * Tk


def causal_pairs(Tq: int, Tk: int, causal: bool, window: int = 0,
                 q_offset: int = 0) -> int:
    """(query, key) pairs an attention call reaches: every pair without a
    mask; with the causal mask, query row i at position p = q_offset + i
    reaches the keys max(0, p - window + 1) .. min(p, Tk - 1) (from 0
    without a window).  Summed in closed form: the pairs of positions
    0 .. q_offset + Tq - 1 less those of 0 .. q_offset - 1."""
    if not causal:
        return Tq * Tk

    def upto(n):        # pairs of the query positions 0 .. n - 1
        return _reach(n, Tk) - (_reach(n - window, Tk) if window > 0
                                else 0)
    return upto(q_offset + Tq) - upto(q_offset)


def flash_fwd(B, H, Hkv, hd, Tq, Tk, causal, elem_bytes, window=0,
              q_offset=0):
    """Kernel 2: 4 hd operations per reachable (query, key) pair and query
    head (s = q k and o += p v); q, k, v read and o written once."""
    flops = 4 * hd * H * B * causal_pairs(Tq, Tk, causal, window, q_offset)
    nbytes = elem_bytes * hd * B * (2 * H * Tq + 2 * Hkv * Tk)
    return flops, nbytes


def flash_bwd(B, H, Hkv, hd, Tq, Tk, causal, elem_bytes, window=0,
              q_offset=0):
    """Kernel 3: five products (s, dp, dq, dk, dv) = 10 hd operations per
    reachable pair and query head; q, o, dO, k, v and the float32 lse read
    once, dq, dk, dv written once."""
    flops = 10 * hd * H * B * causal_pairs(Tq, Tk, causal, window, q_offset)
    nbytes = (elem_bytes * hd * B * (4 * H * Tq + 4 * Hkv * Tk)
              + 4 * B * H * Tq)
    return flops, nbytes


def wkv_chunk_flops(B, H, T, hd):
    """Tensor-core operations of kernel 4's chunked route (csrc/wkv.cu,
    ``wkv_chunk_kernel``) with its bf16 high/low split, per 64-step chunk
    and head: the inter-chunk product (3 products of 64 x hd x hd), the
    state's (2), A V (2) and A's three off-diagonal blocks (3 products of
    64 x 16 x hd each); a partial last chunk counts whole (its rows are
    computed)."""
    per_chunk = 2 * 64 * hd * (7 * hd + 9 * 16)
    return B * H * -(-T // 64) * per_chunk


def wkv_fwd(B, H, T, hd, elem_bytes, w_bytes, with_s0, route):
    """Kernel 4 by ``route``: the chunked route's tensor-core products
    (:func:`wkv_chunk_flops`), the step route's 5 hd^2 float32 operations
    per (b, h, t) (r S, the decay, the outer product and their sums).
    Bytes: r, k, v, y in their type and w in its own read (written) once,
    u, S0 and S_final once (float32)."""
    if route == "chunk":
        flops = wkv_chunk_flops(B, H, T, hd)
    else:
        flops = 5 * hd * hd * B * H * T
    nbytes = (4 * elem_bytes + w_bytes) * B * H * T * hd + 4 * H * hd \
        + 4 * B * H * hd * hd * (2 if with_s0 else 1)
    return flops, nbytes


def wkv_bwd_chunk_flops(B, H, T, hd):
    """Tensor-core operations of the WKV backward's chunked route
    (csrc/wkv_bwd_chunk.cu) with its bf16 high/low splits, 2 a
    multiply-add: the state pass's two products (hi, lo) of hd x hd x 64 a
    chunk, forward over all but the last chunk and backward over all; the
    chunk pass's, per chunk and head: 11 products of 64 x hd x 64 (dv's
    kbar dS_e in 3 splits and A^T dY in 2, dA, dA^T, dY S_c^T and V dS_e^T
    in 2 each), the sub-chunk blocks (3 a side, 3 splits, 64 x hd x 16)
    and A's three off-diagonal blocks (3 splits of 64 x 16 x hd each); a
    partial last chunk counts whole."""
    nc = -(-T // 64)
    state = 2 * 2 * hd * hd * 64 * (2 * nc - 1)
    chunk = 2 * (11 * 64 * hd * 64 + 18 * 64 * hd * 16 + 9 * 64 * 16 * hd)
    return B * H * (state + nc * chunk)


def wkv_bwd(B, H, T, hd, elem_bytes, w_bytes, with_s0, with_ds, route):
    """Kernel 4b by ``route``: the chunked route's tensor-core products
    (:func:`wkv_bwd_chunk_flops`), the step route's 12 hd^2 float32
    operations per (b, h, t) (the states' forward walk, 2 hd^2, and the
    backward's five sums and state update, 10 hd^2).  Bytes: r, k, v, dy
    read and dr, dk, dv written once in their type, w read and dw written
    once in its type, u, S0 and dS_final read and dS0 and du's per-row
    partials written once."""
    if route == "chunk":
        flops = wkv_bwd_chunk_flops(B, H, T, hd)
    else:
        flops = 12 * hd * hd * B * H * T
    nbytes = (7 * elem_bytes + 2 * w_bytes) * B * H * T * hd + 4 * H * hd \
        + 4 * B * H * hd * hd * (1 + with_s0 + with_ds) + 4 * B * H * hd
    return flops, nbytes


def rglru_fwd(B, T, C, elem_bytes):
    """Kernel 5: 2 operations an element; a and b read, h written once."""
    return 2 * B * T * C, 3 * elem_bytes * B * T * C


def rglru_bwd(B, T, C, elem_bytes):
    """Kernel 5b: 3 operations an element; a, h, g read once in their
    type, the float32 da, db written once."""
    return 3 * B * T * C, (3 * elem_bytes + 8) * B * T * C
