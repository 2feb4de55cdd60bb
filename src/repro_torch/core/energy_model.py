"""RAPL-calibrated analytic host-CPU power model (PyTorch).

    P = P_pkg_static
      + cores_awake * P_core_static
      + cores_awake * k_dyn * f^3 * util_share      (dynamic, DVFS-cubic)
      + k_mem * throughput                           (DRAM traffic)

Every ``CpuProfile`` field is a Python float that enters a float32 op as a
float32 constant, in the reference's left-to-right order
(``((cores * f) * 1e9) * ipc``), and ``f^3`` is written ``f * f * f``: the
JAX package's ``f**3`` lowers to the same two multiplies.
"""
from __future__ import annotations

import torch

from ._f32 import ftz
from .types import CpuProfile, freq_table


def cpu_capacity_mbps(cpu: CpuProfile, cores, freq_ghz, num_ch):
    """Max transfer throughput (MB/s) the CPU can push at this operating point.

    capacity = cores * f * IPC / cycles_per_byte, with a small per-channel
    protocol overhead that grows cycles/byte as channels are added.
    """
    cpb = ftz(cpu.cycles_per_byte + ftz(cpu.cycles_per_byte_per_ch * num_ch))
    instr_per_s = ftz(ftz(ftz(cores.to(torch.float32) * freq_ghz) * 1e9)
                      * cpu.ipc)
    return ftz(instr_per_s / ftz(cpb * 1e6))  # MB/s


def cpu_load(cpu: CpuProfile, tput_mbps, cores, freq_ghz, num_ch):
    """Fraction of available CPU consumed by the transfer (Algorithm 3 input)."""
    cap = cpu_capacity_mbps(cpu, cores, freq_ghz, num_ch)
    return torch.clamp(ftz(tput_mbps / cap.clamp_min(1e-6)), 0.0, 1.0)


def power_w(cpu: CpuProfile, cores, freq_ghz, util, tput_mbps):
    """Instantaneous package power draw (W)."""
    c = cores.to(torch.float32)
    f3 = ftz(ftz(freq_ghz * freq_ghz) * freq_ghz)
    dyn = ftz(ftz(ftz(c * cpu.core_dyn_w_per_ghz3) * f3)
              * torch.clamp(util, 0.0, 1.0))
    static = ftz(cpu.pkg_static_w + ftz(c * cpu.core_static_w))
    mem = ftz(cpu.mem_w_per_mbps * tput_mbps)
    return ftz(ftz(static + dyn) + mem)


def operating_point(cpu: CpuProfile, cores, freq_idx):
    """(cores, f_GHz) from an integer operating point."""
    table = freq_table(cpu, freq_idx.device)
    f = table[torch.clamp(freq_idx, 0, len(cpu.freq_levels_ghz) - 1).long()]
    c = torch.clamp(cores, 1, cpu.num_cores)
    return c, f


def energy_per_mb(cpu: CpuProfile, cores, freq_ghz, tput_mbps, num_ch):
    """J/MB at steady state — used by napkin-math tests & Alg-1 sanity checks."""
    util = cpu_load(cpu, tput_mbps, cores, freq_ghz, num_ch)
    p = power_w(cpu, cores, freq_ghz, util, tput_mbps)
    return ftz(p / tput_mbps.clamp_min(1e-6))
