"""Float32 building blocks that keep the port bit-exact with the JAX package.

Four habits of PyTorch would otherwise change the last bit of a result:

* XLA (on the CPU, as on the TPU) flushes float32 subnormals to zero, in
  and out of every operation; PyTorch keeps them.  The difference is not
  academic: a partition whose channel share is proportional to its
  remaining bytes drains geometrically, and only the flush lets it reach
  zero.  :func:`ftz` flushes, and the eager modules apply it to the result
  of every ``+ − × ÷`` (a product with a 0/1 mask cannot make a
  subnormal, and is left alone).  The CUDA kernel is built with
  ``-ftz=true``, which does the same in hardware.
* ``python_float / tensor`` lowers to ``reciprocal(tensor) * float`` (and on
  CUDA, ``tensor / cpu_scalar`` to a multiply by the reciprocal), which is
  not a correctly rounded division.  :func:`rdiv` divides tensor by tensor.
* ``torch.sum`` picks its own reduction order.  The JAX package's sums over
  the (at most eight) partitions of a transfer run left to right, and so
  does :func:`sum_lr` — and the CUDA kernel's scalar loop.
* Per-transfer scalars carry a leading lane axis ``[B]`` while partition
  arrays are ``[B, P]``; :func:`col` lines the former up with the latter
  (``vmap`` did that implicitly).

:func:`interp_f32` is ``jnp.interp`` (no ``left`` / ``right`` /
``period``) written op for op in these terms.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: The largest float32 subnormal: ``|x| <=`` this flushes to zero.
SUBNORMAL_MAX = 1.1754942106924411e-38

#: ``np.spacing(np.finfo(np.float32).eps)`` (2**-46): below it ``jnp.interp``
#: treats a table step as empty.
INTERP_DX_EPS = 1.4210854715202004e-14


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to zero (one op: a hard shrink by the
    largest subnormal; NaN and infinities pass through)."""
    return F.hardshrink(x, SUBNORMAL_MAX)


def col(x: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar ``[...]`` as a column ``[..., 1]``."""
    return x[..., None]


def sum_lr(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (partition) axis, strictly left to right."""
    s = x[..., 0]
    for p in range(1, x.shape[-1]):
        s = ftz(s + x[..., p])
    return s


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` for a Python float ``num``, as a true float32 division."""
    return ftz(torch.div(torch.full_like(den, num), den))


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``torch.where`` with a per-lane ``cond`` broadcast over the trailing
    axes ``a`` may have (the partition axis of ``[B, P]`` fields)."""
    while cond.dim() < a.dim():
        cond = cond[..., None]
    return torch.where(cond, a, b)


def interp_f32(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp(x, xp, fp)`` op for op (jax/_src/numpy/lax_numpy.py
    ``_interp``): the bracketing step ``i = clip(searchsorted(xp, x,
    right), 1, n - 1)``, ``fp[i-1] + ((x - xp[i-1]) / dx) * df`` (or
    ``fp[i-1]`` where ``|dx| <= spacing(eps)``), and ``fp[0]`` / ``fp[-1]``
    outside the table.  ``xp`` and ``fp`` are float32 ``[n]``, ``n >= 2``,
    on ``x``'s device; every ``+ - x /`` is flushed, the division is tensor
    by tensor."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    df = ftz(f1 - f0)
    dx = ftz(x1 - x0)
    delta = ftz(x - x0)
    dx0 = dx.abs() <= INTERP_DX_EPS
    step = ftz(torch.div(delta, torch.where(dx0, torch.ones_like(dx), dx)))
    f = torch.where(dx0, f0, ftz(f0 + ftz(step * df)))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
