"""Streaming wave scheduler: thousands of transfers through one engine.

``run_fleet`` executes an arrival trace against a host pool in *waves* of
``wave_s`` simulated seconds:

1. **Admit.**  Arrivals whose time has come are assigned to hosts (pinned,
   least-loaded, or round-robin) subject to each host's transfer-slot
   budget; the rest queue FIFO.  Admission state (the packed parameter row
   and tick-0 state rows) is built once per unique
   (controller, datasets, profile, cpu, environment) combination and shared
   across the trace — menu-based traces prepare dozens of combos, not
   thousands.
2. **Rescale.**  Per host, if the per-flow bandwidth demands of its
   in-flight transfers exceed the NIC, every transfer on that host gets its
   available bandwidth scaled by ``nic / demand`` for the coming wave (the
   wave's one share per lane — the engine hook).
3. **Run.**  Active lanes are grouped by (controller code, environment
   code, cpu, controller stride) — exactly the ``sweep`` grouping, so a
   heterogeneous pool (per-host environments, see
   ``repro_torch.fleet.hosts``) runs one lane batch per distinct physics —
   partition-padded to the trace-wide maximum
   (``repro_torch.api.scenario.pad_partition_inputs``), stacked, and
   advanced ``wave_steps`` ticks.  On a card every group of the wave goes
   through the tick kernel's wave mode in ONE launch
   (``repro_torch.core.engine.run_cuda_wave_groups``); on the CPU each
   group runs the plain wave loop (``engine.get_wave_runner``).  With
   several devices each group's lanes are split over them
   (``repro_torch.distributed.sharding``), each device runs the executor
   resolved for it, and every device's share is started before any result
   is copied back.
4. **Drain & refill.**  Lanes whose transfers drained (or exceeded their
   budget) are retired, their host slots freed, and the next wave admits
   from the queue.

Because the wave shares the engine's per-tick step function and completion
masking, a transfer that never sees contention (bandwidth share 1.0
throughout) is **bit-identical** to an independent ``api.run`` of the same
scenario.  All scheduling decisions are functions of (arrival time, request
content), never of trace order, so shuffling a trace leaves every fleet
number unchanged.

Lane state is held host-side as the flat ``repro_torch.core.tickstate``
rows (numpy), as in the JAX package: a wave batch is five ``np.stack``
calls, one host-to-device copy per array and one copy back per output.
The JAX package pads each group to a power-of-two lane bucket to bound its
recompiles; nothing is compiled per shape here, so lanes are not padded
(padding lanes are drained no-ops and would change no result).

The admission/rescale decisions themselves (combo preparation, host
picking, NIC shares, tick budgets, retirement records) live in
``repro_torch.fleet.admission``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.scenario import resolve_device
from repro_torch.core import engine, tickstate
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import tick_loop as tl

from .admission import (Combo, budget_steps, combo_key, make_transfer,
                        nic_shares, pick_host, resume_request)
from .aggregates import FleetReport, FleetTransfer, HostStats
from .arrivals import TransferRequest, request_sort_key
from .hosts import Host


@dataclasses.dataclass
class _Lane:
    """One in-flight transfer (mutable host-side bookkeeping).

    The engine carry lives as the two flat ``TickLayout`` rows (numpy), so
    stacking a wave batch is a handful of ``np.stack`` calls."""

    seq: int                       # admission order (stable report order)
    req: TransferRequest
    host_idx: int
    combo: Combo
    st_f32: np.ndarray             # flat f32 state row (TickLayout)
    st_i32: np.ndarray             # flat i32 state row (TickLayout)
    start_s: float
    budget_steps: int
    steps_done: int = 0
    done_at: int = -1


def _stack_group(lanes: list, shares: list) -> tuple:
    """A group's lane batch as host arrays: ``(prow, bw, f32, i32,
    step0)``."""
    return (np.stack([ln.combo.params_row for ln in lanes]),
            np.asarray(shares, np.float32),
            np.stack([ln.st_f32 for ln in lanes]),
            np.stack([ln.st_i32 for ln in lanes]),
            np.asarray([ln.steps_done for ln in lanes], np.int32))


def _to_device(dev, items: list):
    """The rows of every group of ``items`` (``[(group key, host rows)]``)
    on ``dev``, one copy per array: ``[(key, rows on dev)]``, each group's
    rows a slice of the copies."""
    cols = [torch.from_numpy(np.concatenate([rows[k] for _, rows in items]))
            .to(dev) for k in range(5)]
    offs = np.cumsum([0] + [len(rows[1]) for _, rows in items])
    return [(key, [c[a:b] for c in cols])
            for (key, _), a, b in zip(items, offs[:-1], offs[1:])]


def _to_host(res: list) -> list:
    """Each group's ``(f32', i32', done_at)`` as host arrays, one copy back
    per output."""
    outs = [torch.cat([r[k] for r in res]).cpu().numpy() for k in range(3)]
    offs = np.cumsum([0] + [len(r[2]) for r in res])
    return [tuple(o[a:b] for o in outs) for a, b in zip(offs[:-1], offs[1:])]


def _launch_on_device(dev, items: list, wave_steps: int, dt: float,
                      lay: tickstate.TickLayout, executor: str) -> list:
    """Start one device's share of a wave: ``items`` is ``[(group key, host
    rows)]``.  The rows go to ``dev`` (:func:`_to_device`) and each group
    runs as a slice of them: with the ``cuda`` executor (``executor`` is
    already resolved for ``dev``) all groups in one launch of the tick
    kernel's wave mode, queued without a wait; with ``reference`` the plain
    wave loop.  Returns ``[(f32', i32', done_at)]`` on ``dev``, one per
    item."""
    batches = _to_device(dev, items)
    if executor == "cuda":
        return engine.run_cuda_wave_groups([
            tl.Wave(code, env_code, cpu, *rows, wave_steps, dt, ctrl_every)
            for (code, env_code, cpu, ctrl_every), rows in batches])
    return [engine.get_wave_runner(code, env_code, cpu, wave_steps, dt,
                                   ctrl_every, lay.n_partitions)(*rows)
            for (code, env_code, cpu, ctrl_every), rows in batches]


def _run_wave_groups(groups: list, wave_steps: int, dt: float, devices,
                     executors: list, lay: tickstate.TickLayout) -> None:
    """Advance every group of a wave by ``wave_steps`` ticks, in place.

    ``groups`` is ``[(key, lanes, shares)]``; ``executors`` holds each
    device's resolved executor.  With several devices a group of at least
    as many lanes is padded with drained zero lanes to a multiple of the
    device count and split over the devices
    (``sharding.pad_batch(fill="zero")``, ``split_batch``); smaller groups
    run on the first device.  Every device's share is started before any
    result is copied back, so the cards run their shares at once."""
    ndev = len(devices)
    per_dev: list = [[] for _ in devices]
    where = []                  # per group: [(device, item index)]
    for key, lanes, shares in groups:
        rows = _stack_group(lanes, shares)
        if ndev > 1 and len(lanes) >= ndev:
            rows, _ = shd.pad_batch(rows, ndev, fill="zero")
            parts = shd.split_batch(rows, ndev)
        else:
            parts = [rows]
        where.append([])
        for d, part in enumerate(parts):
            where[-1].append((d, len(per_dev[d])))
            per_dev[d].append((key, part))
    started = [_launch_on_device(devices[d], items, wave_steps, dt, lay,
                                 executors[d]) if items else []
               for d, items in enumerate(per_dev)]
    outs = [_to_host(res) if res else [] for res in started]
    for (_, lanes, _), locs in zip(groups, where):
        f32o, i32o, done_at = (np.concatenate(xs) for xs in zip(
            *[outs[d][i] for d, i in locs]))
        for b, ln in enumerate(lanes):
            ln.st_f32 = f32o[b]
            ln.st_i32 = i32o[b]
            ln.steps_done += wave_steps
            if ln.done_at < 0:
                ln.done_at = int(done_at[b])


def run_fleet(trace: Sequence[TransferRequest], hosts: Sequence[Host], *,
              wave_s: float = 30.0, dt: float = 0.1,
              horizon_s: Optional[float] = None,
              assignment: str = "least-loaded",
              devices: Optional[Sequence] = None,
              executor: str = "auto",
              faults=None,
              slo_s: Optional[float] = None) -> FleetReport:
    """Run an arrival trace against a host pool; see the module docstring.

    ``wave_s`` is the scheduling quantum: admissions and bandwidth rescaling
    happen at wave boundaries (a transfer's ``total_s`` budget is quantized
    up to whole waves).  ``horizon_s`` hard-stops the simulation; by default
    the fleet runs until every transfer completes or exhausts its budget.
    ``devices`` are the torch devices the lanes run on (default: the CUDA
    device; pass ``["cpu"]`` for the plain version on the CPU); with
    several, each group's lanes are split over them.  ``executor`` picks the
    wave's lowering, resolved for each device
    (``repro_torch.core.engine.resolve_executor``: ``auto`` is the kernel
    on a card and the plain loop on the CPU; every executor is
    bit-identical).

    ``faults`` injects a fault schedule (any object with the hooks of the
    JAX package's ``repro.workloads.faults.FaultSchedule``: ``churn_fold``,
    ``down_hosts``, ``kills_in``, ``nic_caps`` and ``restart``): host-loss
    windows kill in-flight lanes and block admission, NIC-degrade windows
    cap the contention rescale, named kills requeue transfers with their
    remaining bytes (``restart="resume"``) or from scratch, and the report
    grows a ``churn`` goodput-vs-throughput block.  ``slo_s`` arms
    per-request latency SLO tracking (``latency`` percentiles + ``slo``
    violation block on the report).  Both default to off, leaving the
    fault-free report unchanged.
    """
    hosts = tuple(hosts)
    if not hosts:
        raise ValueError("need at least one host")
    wave_steps = int(round(wave_s / dt))
    if wave_steps < 1:
        raise ValueError(f"wave_s={wave_s} shorter than dt={dt}")
    devices = ([resolve_device(None)] if devices is None
               else [resolve_device(d) for d in devices])
    if not devices:
        raise ValueError("need at least one device")
    executors = [engine.resolve_executor(executor, d) for d in devices]

    reqs = sorted(trace, key=request_sort_key)

    # One prepared Combo per unique admission state; the trace-wide max
    # partition count makes every lane shape-compatible.  The partition
    # count is a function of the datasets alone (Algorithm-1 chunking
    # splits files *within* partitions), so p_max from the pre-pass also
    # covers combos created later for other hosts' CPU profiles or
    # environments.
    combos: dict[tuple, Combo] = {}
    p_max = 0
    finalized = False

    def combo_for(req: TransferRequest, host: Host) -> Combo:
        ck = combo_key(req, host)
        if ck not in combos:
            c = Combo(req, host, dt)
            # Combos created after the pre-pass (an unpinned request landing
            # on a host whose (cpu, environment) no earlier combo covered)
            # finalize immediately: p_max is already trace-wide.
            if finalized:
                c.finalize(p_max)
            combos[ck] = c
        return combos[ck]

    for req in reqs:
        if req.host is not None and not 0 <= req.host < len(hosts):
            raise ValueError(f"request {req.name!r} pinned to host "
                             f"{req.host}, pool has {len(hosts)}")
        host = hosts[req.host] if req.host is not None else hosts[0]
        p_max = max(p_max, combo_for(req, host).n_partitions)
    for c in combos.values():
        c.finalize(p_max)
    finalized = True
    lay = tickstate.TickLayout(max(p_max, 1))

    lanes: list[_Lane] = []
    waiting: list[TransferRequest] = []
    results: list[FleetTransfer] = []
    active = [0] * len(hosts)
    busy_waves = [0] * len(hosts)
    moved_mb = [0.0] * len(hosts)
    peak = [0] * len(hosts)
    rr = [0]
    ai = 0
    seq = 0
    wave = 0
    waves_run = 0
    churn = faults.churn_fold() if faults is not None else None
    last_fault_s = -math.inf

    def retire(ln: _Lane) -> None:
        name = ln.req.name or f"xfer-{ln.seq}"
        rec = make_transfer(
            lay, ln.st_f32,
            name=name,
            controller=ln.combo.ctrl_name,
            host=hosts[ln.host_idx].name,
            arrival_s=ln.req.arrival_s,
            start_s=ln.start_s,
            steps_done=ln.steps_done,
            done_at=ln.done_at,
            dt=dt,
            ideal_s=ln.combo.ideal_s,
        )
        results.append(rec)
        if churn is not None:
            churn.retire(name, attempt=ln.req.attempt,
                         completed=rec.completed,
                         offered_parts=ln.combo.offered_parts,
                         remaining_parts=ln.st_f32[:lay.n_partitions],
                         energy_j=rec.energy_j)
        active[ln.host_idx] -= 1

    while lanes or waiting or ai < len(reqs):
        now = wave * wave_s
        if horizon_s is not None and now >= horizon_s:
            break
        while ai < len(reqs) and reqs[ai].arrival_s <= now:
            waiting.append(reqs[ai])
            ai += 1

        # Fault injection at the wave boundary: kill lanes on down hosts
        # and named-kill victims, requeue what remains via resume_request,
        # victims in name-sorted order.
        down = frozenset()
        if faults is not None:
            down = faults.down_hosts(now, now + wave_s)
            kill_names = faults.kills_in(last_fault_s, now)
            last_fault_s = now
            victims = []
            for ln in lanes:
                name = ln.req.name or f"xfer-{ln.seq}"
                if ln.host_idx in down:
                    victims.append((name, "host", ln))
                elif name in kill_names:
                    victims.append((name, "kill", ln))
            if victims:
                victims.sort(key=lambda v: v[0])
                dead = set()
                for name, kind, ln in victims:
                    rem = ln.st_f32[:lay.n_partitions]
                    requeue = resume_request(ln.req, name, ln.combo.specs,
                                             rem, restart=faults.restart)
                    churn.kill(name, kind=kind, attempt=ln.req.attempt,
                               offered_parts=ln.combo.offered_parts,
                               remaining_parts=rem,
                               energy_j=float(lay.energy_j(ln.st_f32)),
                               requeued=requeue is not None)
                    if requeue is not None:
                        waiting.append(requeue)
                    active[ln.host_idx] -= 1
                    dead.add(id(ln))
                lanes = [ln for ln in lanes if id(ln) not in dead]

        still = []
        for req in waiting:
            h = pick_host(req, hosts, active, assignment, rr, down)
            if h is None:
                still.append(req)
                continue
            combo = combo_for(req, hosts[h])
            lanes.append(_Lane(
                seq=seq, req=req, host_idx=h, combo=combo,
                st_f32=combo.f0, st_i32=combo.i0, start_s=now,
                budget_steps=budget_steps(req, dt)))
            seq += 1
            active[h] += 1
            peak[h] = max(peak[h], active[h])
        waiting = still

        if not lanes:
            if waiting:
                # Queued but nothing admissible (fault-downed hosts, or a
                # request pinned to one): step wave by wave until a host
                # returns.  Unreachable without faults — an unadmissible
                # queue implies a full, i.e. busy, host.
                wave += 1
                continue
            # Idle gap: jump straight to the wave of the next arrival.
            wave = max(wave + 1,
                       int(math.ceil(reqs[ai].arrival_s / wave_s)))
            continue

        # Per-host NIC contention: proportional rescale when the per-flow
        # demands of a host's in-flight transfers exceed its NIC (capacity
        # capped by any fault-injected degrade window overlapping the
        # coming wave).
        demand = [0.0] * len(hosts)
        for ln in lanes:
            demand[ln.host_idx] += ln.req.profile.bandwidth_mbps
        caps = (faults.nic_caps(hosts, now, now + wave_s)
                if faults is not None else None)
        share = nic_shares(hosts, demand, caps)

        moved_before = [lay.bytes_moved(ln.st_f32) for ln in lanes]
        groups: dict[tuple, list[int]] = defaultdict(list)
        for i, ln in enumerate(lanes):
            groups[ln.combo.key].append(i)
        _run_wave_groups(
            [(key, [lanes[i] for i in idxs],
              [share[lanes[i].host_idx] for i in idxs])
             for key, idxs in groups.items()],
            wave_steps, dt, devices, executors, lay)

        hosts_active = set()
        for before, ln in zip(moved_before, lanes):
            moved_mb[ln.host_idx] += lay.bytes_moved(ln.st_f32) - before
            hosts_active.add(ln.host_idx)
        for h in hosts_active:
            busy_waves[h] += 1
        waves_run += 1

        live = []
        for ln in lanes:
            done = lay.remaining_sum(ln.st_f32) <= 0.0
            if done or ln.steps_done >= ln.budget_steps:
                retire(ln)
            else:
                live.append(ln)
        lanes = live
        wave += 1

    dropped = len(waiting) + (len(reqs) - ai)
    for ln in lanes:       # horizon cut: in-flight lanes are incomplete
        retire(ln)
    results.sort(key=lambda t: (t.start_s, t.name))

    # busy_frac is over ALL simulated waves (final `wave` spans sim_s,
    # including the idle gaps the scheduler fast-forwarded past);
    # waves_run counts only waves actually executed.
    stats = tuple(
        HostStats(
            name=h.name,
            moved_mb=float(moved_mb[i]),
            busy_frac=busy_waves[i] / max(wave, 1),
            nic_util=(moved_mb[i]
                      / max(h.nic_mbps * busy_waves[i] * wave_s, 1e-9)),
            peak_active=peak[i],
        )
        for i, h in enumerate(hosts))
    if churn is not None:
        churn.finalize()
    return FleetReport(transfers=tuple(results), host_stats=stats,
                       sim_s=wave * wave_s, waves=waves_run,
                       wave_s=wave_s, dt=dt, dropped=dropped,
                       slo_s=slo_s,
                       churn=churn.report() if churn is not None else None)
