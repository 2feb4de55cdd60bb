"""Flat (structure-of-arrays) rows of the engine's tick state.

The engine's semantics are defined over NamedTuples — ``SimState`` +
``TunerState`` carries and a ``ScanInputs`` parameter bundle — because that
is the shape controllers and environments are written against.  The tick
kernel instead moves state around as dense rows, one per lane:

* one ``float32`` row of ``2 * P + 9`` slots
  (``remaining_mb[P] · window_mb[P] · t · energy_j · bytes_moved ·
  num_ch · prev_num_ch · ref · acc_mb · acc_j · acc_s``),
* one ``int32`` row of 3 slots (``fsm · cores · freq_idx``),

plus a ``13 + 5 * P`` parameter row (``NetParams`` scalars, ``SLAParams``
scalars, then the five per-partition arrays).  The offsets are the JAX
package's, slot for slot.

Pack and unpack are pure concatenation and slicing — no arithmetic, no
dtype conversion — so ``unpack(pack(x)) == x`` bit for bit.  They work on
tensors with any leading (lane) shape.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .types import NetParams, SimState, SLAParams, TunerState

@functools.lru_cache(maxsize=None)
def _const_table(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def const_table(values: tuple, device=None) -> torch.Tensor:
    """A static float32 lookup table (the DVFS V(f) curves, a fitted
    bandwidth schedule) on ``device``: one tensor per distinct (values,
    device), uploaded once.  Every caller shares it, so it is read-only by
    contract: nothing in the port writes to it (PyTorch has no read-only
    tensors to enforce that)."""
    return _const_table(tuple(float(v) for v in values),
                        torch.device(device or "cpu"))


# Scalar slots appended after the two [P] blocks of the f32 state row.
_SIM_SCALARS = ("t", "energy_j", "bytes_moved")
_TS_F32 = ("num_ch", "prev_num_ch", "ref", "acc_mb", "acc_j", "acc_s")
_TS_I32 = ("fsm", "cores", "freq_idx")

N_NET = len(NetParams._fields)          # 6
N_SLA = len(SLAParams._fields)          # 7
# Per-partition [P] arrays in the parameter row, in order.
_PARAM_VECTORS = ("pp", "par", "total_mb", "avg_file_mb", "static_w")


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _stack(xs, dtype) -> torch.Tensor:
    return torch.stack([torch.as_tensor(x, dtype=dtype) for x in xs], dim=-1)


class TickLayout:
    """Slot offsets of the flat state / parameter rows for ``P`` partitions."""

    __slots__ = ("n_partitions", "sim_size", "f32_size", "i32_size",
                 "params_size", "off_t", "off_energy", "off_bytes")

    def __init__(self, n_partitions: int):
        p = int(n_partitions)
        if p < 1:
            raise ValueError(f"need at least one partition, got {p}")
        self.n_partitions = p
        self.sim_size = 2 * p + len(_SIM_SCALARS)
        self.f32_size = self.sim_size + len(_TS_F32)
        self.i32_size = len(_TS_I32)
        self.params_size = N_NET + N_SLA + len(_PARAM_VECTORS) * p
        self.off_t = 2 * p
        self.off_energy = 2 * p + 1
        self.off_bytes = 2 * p + 2

    def __eq__(self, other):
        return (type(other) is TickLayout
                and other.n_partitions == self.n_partitions)

    def __hash__(self):
        return hash((TickLayout, self.n_partitions))

    # ---------------------------------------------------------- state ----

    def pack_sim(self, sim: SimState) -> torch.Tensor:
        """SimState -> f32 row prefix [..., sim_size].  Pure concatenation."""
        return torch.cat([
            _as_f32(sim.remaining_mb), _as_f32(sim.window_mb),
            _stack([getattr(sim, f) for f in _SIM_SCALARS], torch.float32),
        ], dim=-1)

    def unpack_sim(self, row) -> SimState:
        """f32 row prefix -> SimState.  Pure slicing."""
        p = self.n_partitions
        return SimState(
            remaining_mb=row[..., 0:p],
            window_mb=row[..., p:2 * p],
            t=row[..., self.off_t],
            energy_j=row[..., self.off_energy],
            bytes_moved=row[..., self.off_bytes],
        )

    def pack_state(self, sim: SimState, ts: TunerState):
        """(SimState, TunerState) -> (f32 row, i32 row).  Bit-exact inverse
        of :meth:`unpack_state`."""
        f32 = torch.cat([
            self.pack_sim(sim),
            _stack([getattr(ts, f) for f in _TS_F32], torch.float32),
        ], dim=-1)
        i32 = _stack([getattr(ts, f) for f in _TS_I32], torch.int32)
        return f32, i32

    def unpack_state(self, f32, i32) -> tuple[SimState, TunerState]:
        """(f32 row, i32 row) -> (SimState, TunerState).  Pure slicing."""
        s = self.sim_size
        ts = TunerState(
            fsm=i32[..., 0], cores=i32[..., 1], freq_idx=i32[..., 2],
            num_ch=f32[..., s + 0], prev_num_ch=f32[..., s + 1],
            ref=f32[..., s + 2], acc_mb=f32[..., s + 3],
            acc_j=f32[..., s + 4], acc_s=f32[..., s + 5],
        )
        return self.unpack_sim(f32[..., :s]), ts

    # ------------------------------------------------------ parameters ----

    def pack_params(self, inp) -> torch.Tensor:
        """ScanInputs (minus ``state0``/``bw``) -> parameter row."""
        parts = [_stack(list(inp.net), torch.float32),
                 _stack(list(inp.sla), torch.float32)]
        parts += [_as_f32(getattr(inp, f)) for f in _PARAM_VECTORS]
        return torch.cat(parts, dim=-1)

    def unpack_params(self, row) -> dict:
        """Parameter row -> ScanInputs field dict (pure slicing)."""
        p = self.n_partitions
        out = {
            "net": NetParams(*[row[..., i] for i in range(N_NET)]),
            "sla": SLAParams(*[row[..., N_NET + i] for i in range(N_SLA)]),
        }
        base = N_NET + N_SLA
        for k, f in enumerate(_PARAM_VECTORS):
            out[f] = row[..., base + k * p: base + (k + 1) * p]
        return out
