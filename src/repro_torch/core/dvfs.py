"""First-principles DVFS host physics: CV²f dynamic power + leakage (PyTorch).

The reference ``energy_model`` folds voltage into a calibrated cubic
(``k_dyn * f^3``); this model keeps the quantity DVFS trades on — supply
voltage:

  * a **voltage-frequency curve** per silicon technology: ``V(f)`` sample
    points, linearly interpolated (:func:`~repro_torch.core._f32.interp_f32`,
    ``jnp.interp`` op for op) and clamped at the table edges;
  * **dynamic power** ``P_dyn = C_eff · V² · f · a`` with ``C_eff`` the
    per-core switched capacitance (nF: with volts and GHz, watts) and ``a``
    the per-core utilization;
  * **leakage** per awake core ``P_leak(V) = leak_w + leak_w_per_v · V``,
    plus the package's constant uncore draw;
  * **per-core-type constants**: cores past ``n_big`` are efficiency cores
    with fractions of a big core's throughput, capacitance and leakage;
  * **race-to-idle vs pace-to-deadline**: in ``"race"`` mode the idle
    fraction of a tick parks core leakage down to ``idle_leak_frac``; in
    ``"pace"`` mode awake cores leak at full rate.

**Degeneration.**  :meth:`DvfsEnergyModel.matched` builds the tables that
collapse onto the reference model: ``V(f) = f`` at the ladder's nodes (so
``C·V²·f == k·f³``), capacitance ``core_dyn_w_per_ghz3``, voltage-free
leakage ``core_static_w``, all cores big, pace accounting.  Every float32
expression is grouped as the reference's (``(v * v) * f`` as ``f * f * f``)
so the degeneration is bit-exact, as in the JAX package.

:class:`DvfsNetworkModel` is the reference WAN physics under the ``dvfs``
name: its ``step`` delegates to :mod:`repro_torch.core.network_model`.  The
JAX package also gives it a flat-row ``step_arrays`` lowering for its
blocked and Pallas executors; the port has neither — its flat path is the
CUDA tick kernel, which spells out the dvfs energy model itself
(``kernels/csrc/tick_loop.cu``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import network_model
from ._f32 import ftz, interp_f32
from .tickstate import const_table
from .types import CpuProfile, SimState, freq_table

#: Technology presets: a high-performance process ("hp": steep leakage,
#: shallow V(f) slope) and a low-power one ("lp": little leakage, a steep
#: V(f) wall past ~2 GHz).  The JAX package's values.
DVFS_TECHS = {
    "hp": dict(
        vf_ghz=(0.8, 1.2, 1.6, 2.0, 2.4, 2.8, 3.2),
        vf_volt=(0.65, 0.74, 0.83, 0.93, 1.04, 1.16, 1.29),
        cap_nf=3.9, leak_w=0.15, leak_w_per_v=0.8),
    "lp": dict(
        vf_ghz=(0.6, 1.0, 1.4, 1.8, 2.2, 2.6, 3.0),
        vf_volt=(0.72, 0.86, 1.01, 1.17, 1.34, 1.52, 1.71),
        cap_nf=3.4, leak_w=0.02, leak_w_per_v=0.12),
}

IDLE_MODES = ("race", "pace")


def core_mix(cores, n_big: int):
    """(big, little) float32 core counts of an int32 core count."""
    c = torch.as_tensor(cores).to(torch.float32)
    big = c.clamp_max(float(n_big))
    little = ftz(c - float(n_big)).clamp_min(0.0)
    return big, little


def mixed_capacity_mbps(cpu: CpuProfile, cores, freq_ghz, num_ch,
                        n_big: int, little_perf: float):
    """Max MB/s of ``cores`` awake cores, the first ``n_big`` big and the
    rest little at ``little_perf`` of a big core's throughput (the
    reference model's capacity when every core is big)."""
    big, little = core_mix(cores, n_big)
    core_eff = ftz(big + ftz(little * little_perf))
    cpb = ftz(cpu.cycles_per_byte + ftz(cpu.cycles_per_byte_per_ch * num_ch))
    instr_per_s = ftz(ftz(ftz(core_eff * freq_ghz) * 1e9) * cpu.ipc)
    return ftz(instr_per_s / ftz(cpb * 1e6))


@dataclasses.dataclass(frozen=True)
class DvfsEnergyModel:
    """CV²f + leakage host power physics (see the module docstring).

    Frozen and hashable: an instance joins the sweep group key, so two V(f)
    tables run as two lane batches."""

    name = "dvfs"
    tech: str = "hp"                 # preset label (repr only)
    vf_ghz: tuple = DVFS_TECHS["hp"]["vf_ghz"]
    vf_volt: tuple = DVFS_TECHS["hp"]["vf_volt"]
    cap_nf: float = DVFS_TECHS["hp"]["cap_nf"]      # C_eff per big core
    leak_w: float = DVFS_TECHS["hp"]["leak_w"]      # per-core leakage at V=0
    leak_w_per_v: float = DVFS_TECHS["hp"]["leak_w_per_v"]  # dP_leak/dV
    n_big: int = 8
    little_perf: float = 0.45        # little-core throughput / big-core
    little_cap_frac: float = 0.25    # little-core C_eff / big-core
    little_leak_frac: float = 0.5    # little-core leakage / big-core
    idle: str = "pace"               # "race" (race-to-idle) | "pace"
    idle_leak_frac: float = 0.05     # residual leakage while parked (race)
    max_freq_ghz: float | None = None  # DVFS governor cap on the ladder

    def __post_init__(self):
        if len(self.vf_ghz) != len(self.vf_volt) or len(self.vf_ghz) < 2:
            raise ValueError(
                f"V(f) table needs >= 2 matched (f, V) samples, got "
                f"{len(self.vf_ghz)} freqs / {len(self.vf_volt)} volts")
        if any(b <= a for a, b in zip(self.vf_ghz, self.vf_ghz[1:])):
            raise ValueError(f"vf_ghz must be strictly increasing, got "
                             f"{self.vf_ghz}")
        if any(v <= 0.0 for v in self.vf_volt):
            raise ValueError(f"vf_volt must be positive, got {self.vf_volt}")
        if self.cap_nf <= 0.0:
            raise ValueError(f"cap_nf must be positive, got {self.cap_nf}")
        if self.leak_w < 0.0 or self.leak_w_per_v < 0.0:
            raise ValueError("leakage constants must be >= 0, got "
                             f"leak_w={self.leak_w}, "
                             f"leak_w_per_v={self.leak_w_per_v}")
        if self.n_big < 1:
            raise ValueError(f"n_big must be >= 1, got {self.n_big}")
        for f in ("little_perf", "little_cap_frac", "little_leak_frac"):
            v = getattr(self, f)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{f} must be in (0, 1], got {v}")
        if self.idle not in IDLE_MODES:
            raise ValueError(f"idle must be one of {IDLE_MODES}, got "
                             f"{self.idle!r}")
        if not 0.0 <= self.idle_leak_frac <= 1.0:
            raise ValueError(f"idle_leak_frac must be in [0, 1], got "
                             f"{self.idle_leak_frac}")
        if self.max_freq_ghz is not None and self.max_freq_ghz <= 0.0:
            raise ValueError(f"max_freq_ghz must be positive (or None), "
                             f"got {self.max_freq_ghz}")

    @classmethod
    def for_tech(cls, tech: str = "hp", **overrides) -> "DvfsEnergyModel":
        """Build from a :data:`DVFS_TECHS` preset; kwargs override fields."""
        try:
            base = DVFS_TECHS[tech]
        except KeyError:
            raise KeyError(f"unknown DVFS technology {tech!r}; expected one "
                           f"of {tuple(sorted(DVFS_TECHS))}") from None
        return cls(tech=tech, **{**base, **overrides})

    @classmethod
    def matched(cls, cpu: CpuProfile) -> "DvfsEnergyModel":
        """The tables that degenerate to the reference model bit-exactly on
        ``cpu``: V(f) = f, C_eff = ``core_dyn_w_per_ghz3``, leakage
        ``core_static_w`` independent of V, every core big, pace
        accounting, no governor cap."""
        ladder = tuple(float(f) for f in cpu.freq_levels_ghz)
        return cls(tech="matched", vf_ghz=ladder, vf_volt=ladder,
                   cap_nf=cpu.core_dyn_w_per_ghz3,
                   leak_w=cpu.core_static_w, leak_w_per_v=0.0,
                   n_big=max(cpu.num_cores, 1), idle="pace")

    def code(self) -> "DvfsEnergyModel":
        return self

    # ------------------------------------------------------------ physics --

    def voltage(self, freq_ghz):
        """V(f): linear interpolation over the technology's sample points,
        clamped at the table edges; exact at the nodes."""
        f = torch.as_tensor(freq_ghz, dtype=torch.float32)
        return interp_f32(f, const_table(self.vf_ghz, f.device),
                          const_table(self.vf_volt, f.device))

    def operating_point(self, cpu, cores, freq_idx):
        table = freq_table(cpu, freq_idx.device)
        f = table[torch.clamp(freq_idx, 0,
                              len(cpu.freq_levels_ghz) - 1).long()]
        if self.max_freq_ghz is not None:
            f = f.clamp_max(float(np.float32(self.max_freq_ghz)))
        return torch.clamp(cores, 1, cpu.num_cores), f

    def cpu_capacity_mbps(self, cpu, cores, freq_ghz, num_ch):
        return mixed_capacity_mbps(cpu, cores, freq_ghz, num_ch, self.n_big,
                                   self.little_perf)

    def cpu_load(self, cpu, tput_mbps, cores, freq_ghz, num_ch):
        cap = self.cpu_capacity_mbps(cpu, cores, freq_ghz, num_ch)
        return torch.clamp(ftz(tput_mbps / cap.clamp_min(1e-6)), 0.0, 1.0)

    def power_w(self, cpu, cores, freq_ghz, util, tput_mbps):
        big, little = core_mix(cores, self.n_big)
        u = torch.clamp(torch.as_tensor(util, dtype=torch.float32), 0.0, 1.0)
        f = torch.as_tensor(freq_ghz, dtype=torch.float32)
        v = self.voltage(f)
        # (v * v) * f: the reference's f * f * f when V(f) = f.
        dyn = ftz(ftz(ftz(ftz(big + ftz(little * self.little_cap_frac))
                          * self.cap_nf) * ftz(ftz(v * v) * f)) * u)
        per_core = ftz(self.leak_w + ftz(self.leak_w_per_v * v))
        if self.idle == "race":
            # The parked fraction of the tick keeps idle_leak_frac of it.
            per_core = ftz(per_core * ftz(
                u + ftz(self.idle_leak_frac * ftz(1.0 - u))))
        static = ftz(cpu.pkg_static_w
                     + ftz(ftz(big + ftz(little * self.little_leak_frac))
                           * per_core))
        mem = ftz(cpu.mem_w_per_mbps * torch.as_tensor(tput_mbps,
                                                       dtype=torch.float32))
        return ftz(ftz(static + dyn) + mem)

    def energy_per_mb(self, cpu, cores, freq_ghz, tput_mbps, num_ch):
        """J/MB at steady state (operating-point sweep helper)."""
        tput = torch.as_tensor(tput_mbps, dtype=torch.float32)
        util = self.cpu_load(cpu, tput, cores, freq_ghz, num_ch)
        p = self.power_w(cpu, cores, freq_ghz, util, tput)
        return ftz(p / tput.clamp_min(1e-6))


@dataclasses.dataclass(frozen=True)
class DvfsNetworkModel:
    """The reference WAN physics under the ``dvfs`` name (the family
    changes host physics, not the wire)."""

    name = "dvfs"

    def code(self) -> "DvfsNetworkModel":
        return self

    def init_state(self, total_mb, net) -> SimState:
        return network_model.init_state(total_mb, net)

    def step(self, energy, net, cpu, state, params, avg_file_mb, dt,
             bw_scale):
        return network_model.step(net, cpu, state, params, avg_file_mb, dt,
                                  bw_scale, energy=energy)
