"""Algorithm 3 — threshold-based dynamic frequency and core scaling.

    if cpuLoad > maxLoad:        # system saturating
        first add cores, then raise frequency
    elif cpuLoad < minLoad:      # system over-provisioned
        first lower frequency, then park cores

Escalation order matters: at equal IPS, (more cores, lower f) beats
(fewer cores, higher f) on energy because dynamic power is cubic in f but
only linear in core count (see energy_model).
"""
from __future__ import annotations

import torch

from .types import CpuProfile


def load_control(cpu: CpuProfile, sla, cpu_load, cores, freq_idx):
    """One Algorithm-3 tick. Returns (cores', freq_idx')."""
    max_f = len(cpu.freq_levels_ghz) - 1

    hot = cpu_load > sla.max_load
    cold = cpu_load < sla.min_load

    can_add_core = cores < cpu.num_cores
    can_raise_f = freq_idx < max_f
    can_lower_f = freq_idx > 0
    can_drop_core = cores > 1

    # hot path: cores first, then frequency (lines 2-7)
    cores_hot = torch.where(can_add_core, cores + 1, cores)
    freq_hot = torch.where(can_add_core, freq_idx,
                           torch.where(can_raise_f, freq_idx + 1, freq_idx))

    # cold path: frequency first, then cores (lines 8-13)
    freq_cold = torch.where(can_lower_f, freq_idx - 1, freq_idx)
    cores_cold = torch.where(can_lower_f, cores,
                             torch.where(can_drop_core, cores - 1, cores))

    new_cores = torch.where(hot, cores_hot,
                            torch.where(cold, cores_cold, cores))
    new_freq = torch.where(hot, freq_hot,
                           torch.where(cold, freq_cold, freq_idx))
    return new_cores.to(torch.int32), new_freq.to(torch.int32)
