"""Discrete-time wide-area transfer simulator (PyTorch, lane-batched).

The same deterministic per-tick model as the JAX package:

  * per-channel TCP rate  = window / RTT, with slow-start window ramp;
  * pipelining  (pp)  amortizes the 1-RTT-per-file control cost of small files;
  * parallelism (par) multiplies the effective window of large files (up to
    the file/buffer ratio);
  * concurrency (cc)  opens more channels, subject to a contention knee past
    the saturation point (over-concurrency *lowers* throughput — §II);
  * the CPU operating point (cores, freq) caps achievable throughput and
    sets power draw (energy_model).

Per-transfer quantities are ``[B]`` tensors and per-partition ones
``[B, P]`` (a single transfer without a lane axis works too).  Every
division is tensor by tensor, every partition sum runs left to right and
every arithmetic result is flushed of subnormals (see ``_f32``), which keeps
a tick bit-identical to the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import energy_model
from ._f32 import col, ftz, rdiv, sum_lr
from .types import CpuProfile, SimState, TransferParams


class NetOut(NamedTuple):
    tput_mbps: torch.Tensor      # [B] total achieved throughput
    part_rate: torch.Tensor      # [B, P] per-partition rates
    cpu_load: torch.Tensor       # [B]
    power_w: torch.Tensor        # [B]
    num_ch: torch.Tensor         # [B] total active channels


def channel_rate(profile, window_mb, avg_file_mb, pp, par):
    """Achievable MB/s of ONE channel of each partition (before contention)."""
    # Parallelism multiplies the window, but only while chunks still exceed
    # the socket buffer; past that, extra streams add nothing (paper §II).
    hi = ftz(avg_file_mb / col(profile.buffer_mb)).clamp_min(1.0)
    par_eff = torch.minimum(par.clamp_min(1.0), hi)
    raw = ftz(ftz(par_eff * window_mb) / col(profile.rtt_s))
    # Pipelining: each file costs rtt/pp of dead time on the channel.
    per_file_s = ftz(ftz(avg_file_mb / raw.clamp_min(1e-6))
                     + ftz(col(profile.rtt_s) / pp.clamp_min(1.0)))
    return ftz(avg_file_mb / per_file_s.clamp_min(1e-9))


def contention_efficiency(profile, total_ch, window_mb):
    """Network efficiency in (0,1]: drops once channels exceed saturation."""
    per_ch = ftz(window_mb / profile.rtt_s).clamp_min(1e-6)
    c_sat = ftz(ftz(profile.loss_knee * profile.bandwidth_mbps) / per_ch)
    over = ftz(ftz(total_ch - c_sat).clamp_min(0.0) / c_sat.clamp_min(1.0))
    return rdiv(1.0, ftz(1.0 + ftz(ftz(0.5 * over) * over)))


def step(profile, cpu: CpuProfile, state: SimState, params: TransferParams,
         avg_file_mb, dt: float, bw_scale, energy=None):
    """Advance the transfer by ``dt`` seconds. Returns (state', NetOut).

    ``energy`` supplies the host power physics (the
    ``repro_torch.api.environments.EnergyModel`` protocol); it defaults to
    this package's reference ``energy_model`` module.
    """
    if energy is None:
        energy = energy_model
    active = (state.remaining_mb > 0.0).to(torch.float32)      # [B, P]
    cc = params.cc.clamp_min(0.0) * active
    total_ch = sum_lr(cc)

    # Contention sees only the partitions that still hold channels.
    n_active = sum_lr(active).clamp_min(1.0)
    avg_win = ftz(sum_lr(state.window_mb * active) / n_active)
    r1 = channel_rate(profile, state.window_mb, avg_file_mb, params.pp,
                      params.par)
    demand = ftz(cc * r1)                                       # [B, P]
    total_demand = sum_lr(demand)

    b_avail = ftz(ftz(profile.bandwidth_mbps
                      * ftz(1.0 - profile.cross_traffic)) * bw_scale)
    eff = contention_efficiency(profile, total_ch, avg_win)
    net_cap = ftz(b_avail * eff)

    cores, f = energy.operating_point(cpu, params.cores, params.freq_idx)
    cpu_cap = energy.cpu_capacity_mbps(cpu, cores, f, total_ch)

    tput = torch.minimum(torch.minimum(total_demand, net_cap), cpu_cap)
    scale = ftz(tput / total_demand.clamp_min(1e-6))
    part_rate = ftz(demand * col(scale))                        # [B, P]

    # Drain partitions; surplus reallocation within one tick is a
    # second-order effect we ignore (dt is small).
    moved = torch.minimum(ftz(part_rate * dt), state.remaining_mb)
    remaining = ftz(state.remaining_mb - moved)

    # TCP window slow-start ramp toward the profile's steady-state window.
    ramp = torch.clamp(rdiv(dt, ftz(8.0 * profile.rtt_s)), 0.0, 1.0)
    window = ftz(state.window_mb
                 + ftz(ftz(col(profile.avg_window_mb) - state.window_mb)
                       * col(ramp)))

    load = energy.cpu_load(cpu, tput, cores, f, total_ch)
    pw = energy.power_w(cpu, cores, f, load, tput)

    new_state = SimState(
        remaining_mb=remaining,
        window_mb=window,
        t=ftz(state.t + dt),
        energy_j=ftz(state.energy_j + ftz(pw * dt)),
        bytes_moved=ftz(state.bytes_moved + sum_lr(moved)),
    )
    out = NetOut(tput_mbps=tput, part_rate=part_rate, cpu_load=load,
                 power_w=pw, num_ch=total_ch)
    return new_state, out


def init_state(total_mb, profile) -> SimState:
    """Fresh simulation state; windows start small (TCP slow start).

    ``total_mb`` is ``[..., P]`` (a tensor, or host numpy for one transfer);
    the state's leaves follow its leading shape and device.
    """
    total_mb = torch.as_tensor(total_mb, dtype=torch.float32)
    z = torch.zeros(total_mb.shape[:-1], dtype=torch.float32,
                    device=total_mb.device)
    return SimState(
        remaining_mb=total_mb,
        window_mb=torch.full_like(total_mb, 64.0 / 1024.0),  # 64 KB
        t=z, energy_j=z.clone(), bytes_moved=z.clone(),
    )
