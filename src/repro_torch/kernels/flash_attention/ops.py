"""Public wrapper: model layout [B,T,H,hd] over the kernel's [B,H,T,hd]
(the port of ``repro/kernels/flash_attention/ops.py``).  The layouts differ
only by a ``transpose`` view: the kernel takes strides, so nothing is
copied."""
from __future__ import annotations

from .flash_attention import flash_attention_bhtd
from .ref import attention_ref

EXECUTORS = ("auto", "cuda", "reference")

#: The JAX kernel's K block.  Its wrapper refuses non-causal attention over
#: a partial last block (that kernel leaves the block's tail unmasked), and
#: this one keeps the contract.
BK = 128


def check_executor(executor: str):
    if executor not in EXECUTORS:
        raise ValueError(f"unknown attention executor {executor!r}; have "
                         f"{EXECUTORS}")


def _t(x):
    return x.transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    executor: str = "auto"):
    """q [B,Tq,H,hd], k/v [B,Tk,Hkv,hd] -> [B,Tq,H,hd], by executor:
    ``auto`` is the kernel on a CUDA device and the plain version on the
    CPU; ``cuda`` is the kernel and raises for CPU tensors; ``reference`` is
    the plain version on any device (the card's comparison).

    Non-causal attention requires Tk % BK == 0 (or Tk <= BK)."""
    check_executor(executor)
    if not causal and k.shape[1] % min(BK, k.shape[1]) != 0:
        raise ValueError(
            f"non-causal flash attention needs Tk divisible by bk "
            f"(Tk={k.shape[1]}, bk={BK}); pad K/V")
    if executor == "reference":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if executor == "cuda" and q.device.type != "cuda":
        raise ValueError(f"executor='cuda' needs CUDA tensors, got "
                         f"{q.device}")
    return _t(flash_attention_bhtd(_t(q), _t(k), _t(v), causal=causal,
                                   window=window))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    return _t(attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            window=window))
