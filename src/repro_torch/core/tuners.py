"""The three SLA tuning algorithms (paper §IV, Algorithms 4-6) + Slow Start.

Each tuner is a pure function on lane-batched tensors

    update(ts: TunerState, meas: Measurement, ...) -> TunerState

Branching over FSM states is done with ``torch.where`` chains: every branch
is a handful of scalar flops per lane, so computing all of them is cheaper
than splitting the batch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import fsm
from ._f32 import ftz
from .load_control import load_control
from .types import CpuProfile, SLAPolicy, TunerState


class Measurement(NamedTuple):
    """Observables accumulated over one controller interval ("Timeout")."""

    avg_tput: torch.Tensor      # MB/s over the interval
    energy_j: torch.Tensor      # J consumed during the interval (E_last)
    avg_power: torch.Tensor     # W over the interval
    remaining_mb: torch.Tensor  # total bytes left
    cpu_load: torch.Tensor      # fraction [0,1]
    interval_s: torch.Tensor


def init_tuner_state(num_ch0, cores0, freq_idx0) -> TunerState:
    """Host-side initial tuner state (numpy float32/int32 scalars)."""
    z = np.float32(0.0)
    return TunerState(
        fsm=np.int32(fsm.SLOW_START),
        num_ch=np.float32(num_ch0),
        prev_num_ch=np.float32(num_ch0),
        ref=z,
        cores=np.int32(cores0),
        freq_idx=np.int32(freq_idx0),
        acc_mb=z, acc_j=z, acc_s=z,
    )


def _me_metric(meas: Measurement):
    """E_last + E_future  (Algorithm 4 lines 5-6)."""
    remain_time = ftz(meas.remaining_mb / meas.avg_tput.clamp_min(1e-3))
    e_future = ftz(meas.avg_power * remain_time)
    return ftz(meas.energy_j + e_future)


def _fsm_const(like, value):
    return torch.full_like(like, value)


def slow_start(ts: TunerState, meas: Measurement, profile, sla,
               policy: SLAPolicy) -> TunerState:
    """Algorithm 2 — one corrective step after the first timeout.

    numCh *= bandwidth / lastThroughput, then hand over to INCREASE with the
    reference metric primed from this first measurement.
    """
    goal = profile.bandwidth_mbps
    if policy == SLAPolicy.TARGET_THROUGHPUT:
        tgt = sla.target_tput_mbps
        goal = torch.where(tgt > 0.0, torch.minimum(goal, tgt), goal)
    corr = ftz(goal / meas.avg_tput.clamp_min(1e-3))
    corr = torch.clamp(corr, 0.25, 8.0)  # don't let a cold window explode numCh
    num_ch = torch.minimum(ftz(ts.num_ch * corr).clamp_min(1.0), sla.max_ch)
    ref = _me_metric(meas) if policy == SLAPolicy.MIN_ENERGY \
        else meas.avg_tput
    return ts._replace(fsm=_fsm_const(ts.fsm, fsm.INCREASE),
                       num_ch=num_ch, prev_num_ch=ts.num_ch, ref=ref)


def _where3(in_inc, in_warn, inc, warn, rec):
    return torch.where(in_inc, inc, torch.where(in_warn, warn, rec))


def me_update(ts: TunerState, meas: Measurement, sla) -> TunerState:
    """Algorithm 4 — Minimum energy. Feedback metric: E_last + E_future."""
    m = _me_metric(meas)
    a, b, d, mx = sla.alpha, sla.beta, sla.delta_ch, sla.max_ch
    st, ch, ref = ts.fsm, ts.num_ch, ts.ref

    improved = m < ftz(ftz(1.0 - a) * ref)
    degraded = m > ftz(ftz(1.0 + b) * ref)
    ok = torch.logical_not(degraded)           # m <= (1+β)·E_past

    # INCREASE (lines 7-12)
    ch_inc = torch.where(improved, torch.minimum(ftz(ch + d), mx), ch)
    st_inc = torch.where(degraded, fsm.WARNING, fsm.INCREASE)
    ref_inc = m                                # reference tracks last estimate

    # WARNING (lines 13-19)
    ch_warn = torch.where(ok, ch, ftz(ch - d).clamp_min(1.0))
    st_warn = torch.where(ok, fsm.INCREASE, fsm.RECOVERY)

    # RECOVERY (lines 20-26): keep reduction if it helped, else restore.
    ch_rec = torch.where(ok, ch, torch.minimum(ftz(ch + d), mx))
    st_rec = _fsm_const(st, fsm.INCREASE)
    ref_rec = torch.where(ok, ref, m)          # bandwidth changed -> rebase

    in_inc = st == fsm.INCREASE
    in_warn = st == fsm.WARNING
    return ts._replace(
        fsm=_where3(in_inc, in_warn, st_inc, st_warn, st_rec).to(torch.int32),
        num_ch=_where3(in_inc, in_warn, ch_inc, ch_warn, ch_rec),
        prev_num_ch=ch,
        ref=_where3(in_inc, in_warn, ref_inc, ref, ref_rec))


def eemt_update(ts: TunerState, meas: Measurement, sla) -> TunerState:
    """Algorithm 5 — Energy-efficient maximum throughput."""
    tput = meas.avg_tput
    a, b, d, mx = sla.alpha, sla.beta, sla.delta_ch, sla.max_ch
    st, ch, ref = ts.fsm, ts.num_ch, ts.ref

    better = tput > ftz(ftz(1.0 + b) * ref)
    worse = tput < ftz(ftz(1.0 - a) * ref)
    ok = torch.logical_not(worse)              # tput >= (1−α)·refTput

    # INCREASE (lines 4-10): ratchet refTput on improvement.
    ch_inc = torch.where(better, torch.minimum(ftz(ch + d), mx), ch)
    ref_inc = torch.where(better, tput, ref)
    st_inc = torch.where(worse, fsm.WARNING, fsm.INCREASE)

    # WARNING (lines 11-17)
    ch_warn = torch.where(ok, ch, ftz(ch - d).clamp_min(1.0))
    st_warn = torch.where(ok, fsm.INCREASE, fsm.RECOVERY)

    # RECOVERY (lines 18-26): restore + rebase refTput if bandwidth changed.
    ch_rec = torch.where(ok, ch, torch.minimum(ftz(ch + d), mx))
    ref_rec = torch.where(ok, ref, tput)
    st_rec = _fsm_const(st, fsm.INCREASE)

    in_inc = st == fsm.INCREASE
    in_warn = st == fsm.WARNING
    return ts._replace(
        fsm=_where3(in_inc, in_warn, st_inc, st_warn, st_rec).to(torch.int32),
        num_ch=_where3(in_inc, in_warn, ch_inc, ch_warn, ch_rec),
        prev_num_ch=ch,
        ref=_where3(in_inc, in_warn, ref_inc, ref, ref_rec))


def eett_update(ts: TunerState, meas: Measurement, sla) -> TunerState:
    """Algorithm 6 — Energy-efficient target throughput (3-state FSM)."""
    tput = meas.avg_tput
    a, b, d = sla.alpha, sla.beta, sla.delta_ch
    mx, tgt = sla.max_ch, sla.target_tput_mbps
    st, ch = ts.fsm, ts.num_ch

    high = tput > ftz(ftz(1.0 + b) * tgt)
    low = tput < ftz(ftz(1.0 - a) * tgt)

    # INCREASE (lines 4-7): leave band -> RECOVERY.
    st_inc = torch.where(torch.logical_or(high, low), fsm.RECOVERY,
                         fsm.INCREASE)

    # RECOVERY (lines 8-15): one corrective step, then back to INCREASE.
    ch_rec = torch.where(high, ftz(ch - d).clamp_min(1.0),
                         torch.where(low, torch.minimum(ftz(ch + d), mx), ch))

    in_inc = st == fsm.INCREASE
    return ts._replace(
        fsm=torch.where(in_inc, st_inc, fsm.INCREASE).to(torch.int32),
        num_ch=torch.where(in_inc, ch, ch_rec),
        prev_num_ch=ch,
        ref=tgt)


def ismail_target_update(ts: TunerState, meas: Measurement,
                         sla) -> TunerState:
    """Baseline target tuner of Ismail et al. (paper §V-B): single-channel
    start, +/-1 channel per timeout, no FSM, no slow-start correction."""
    tput = meas.avg_tput
    tgt = sla.target_tput_mbps
    low = tput < ftz(ftz(1.0 - sla.alpha) * tgt)
    high = tput > ftz(ftz(1.0 + sla.beta) * tgt)
    ch = torch.where(low, ftz(ts.num_ch + 1.0),
                     torch.where(high, ftz(ts.num_ch - 1.0), ts.num_ch))
    ch = torch.minimum(ch.clamp_min(1.0), sla.max_ch)
    return ts._replace(num_ch=ch, prev_num_ch=ts.num_ch,
                       fsm=_fsm_const(ts.fsm, fsm.INCREASE))


def _merge(in_ss, ss: TunerState, tuned: TunerState) -> TunerState:
    return TunerState(*[torch.where(in_ss, s, t) for s, t in zip(ss, tuned)])


def update(ts: TunerState, meas: Measurement, profile, cpu: CpuProfile, sla,
           *, scaling: bool, policy: SLAPolicy) -> TunerState:
    """One controller tick: Slow Start / SLA tuner + Algorithm-3 load control.

    ``scaling=False`` disables frequency & core scaling (the Fig. 4
    ablation); ``policy`` selects the code path for the whole lane batch.
    """
    in_ss = ts.fsm == fsm.SLOW_START

    if policy == SLAPolicy.ISMAIL_TARGET:
        # no slow-start correction: the baseline ramps from 1 channel
        ss = ts._replace(fsm=_fsm_const(ts.fsm, fsm.INCREASE))
        return _merge(in_ss, ss, ismail_target_update(ts, meas, sla))

    ss = slow_start(ts, meas, profile, sla, policy)
    if policy == SLAPolicy.MIN_ENERGY:
        tuned = me_update(ts, meas, sla)
    elif policy == SLAPolicy.MAX_THROUGHPUT:
        tuned = eemt_update(ts, meas, sla)
    else:
        tuned = eett_update(ts, meas, sla)

    merged = _merge(in_ss, ss, tuned)
    if scaling:
        cores, freq_idx = load_control(cpu, sla, meas.cpu_load,
                                       merged.cores, merged.freq_idx)
        merged = merged._replace(cores=cores, freq_idx=freq_idx)
    return merged
