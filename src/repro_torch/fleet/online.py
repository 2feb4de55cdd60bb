"""Online fleet operation: an unbounded arrival stream, bounded memory (the
port of ``repro/fleet/online.py``).

``run_fleet_online`` is the operator-scale sibling of
``repro_torch.fleet.scheduler.run_fleet``.  The offline scheduler
materializes the whole trace, every lane object, and every per-transfer
result in one process — fine for 10k transfers, impossible for a service
that admits millions.  The online loop replaces each unbounded structure
with a bounded one and keeps everything else — admission policy, NIC
rescaling, tick budgets, the wave's device step — *identical*, via the
shared ``repro_torch.fleet.admission`` helpers and
``scheduler.run_wave_rows``:

1. **Ingest.**  Arrivals come from a generator (``repro_torch.fleet.
   arrivals`` stream adapters: Poisson, diurnal, replay) consumed lazily
   through a one-item peek buffer; nothing is materialized.  A queue-depth
   watermark pair applies backpressure: ingest pauses when the waiting
   queue reaches ``queue_high`` and resumes at ``queue_low``, so queue
   memory is bounded even when arrivals outpace the pool.
2. **Admit.**  Waiting requests are assigned hosts FIFO with the shared
   ``pick_host`` policy, then claim a slot in their group's
   :class:`repro_torch.fleet.ringbuf.SlotPool` — fixed-capacity,
   preallocated flat ``TickLayout`` rows (host numpy), one pool per
   (controller code, environment code, cpu, stride) group.  Pool full ⇒
   the request waits; retirement recycles slots in place.  Admission is
   *deterministic*: slot indices are a pure function of the arrival
   prefix.
3. **Run.**  Every occupied pool's whole ``[capacity, ...]`` rows advance
   one wave together (free slots are zeroed lanes, born drained): on a
   card in ONE launch of the tick kernel's wave mode for the whole wave
   (``engine.run_cuda_wave_groups``; one per 60 pools), on the CPU through
   the plain wave loop (``engine.get_wave_runner``).  With several devices
   (``OnlineConfig.devices`` or a
   :class:`repro_torch.distributed.sharding.MeshConfig`) ``pool_capacity``
   is rounded up to a multiple of the device count, each pool's rows are
   split over the devices (``sharding.split_batch``), and every device's
   share is started before any is copied back.
4. **Retire & fold.**  Drained (or budget-exhausted) slots produce the
   same retirement record as offline (``admission.make_transfer``), folded
   immediately into :class:`repro_torch.fleet.aggregates.FleetFold` —
   exact streaming totals (order-independent Shewchuk summation, bit-equal
   to the offline ``math.fsum``), DDSketch percentiles with a documented
   relative-error bound — and the slot returns to its pool's free ring.
   On stream end the loop drains gracefully: ingest stops, waves continue
   until the last lane retires.

Only active slots are ever read: the plain wave loop's accumulators of a
zeroed free row come out NaN (as in the JAX package), the kernel leaves
such a row as it was, and neither reaches a report.

Because admission decisions and the wave step are shared with the offline
path, feeding a *sorted* finite trace through ``replay_stream`` with
capacity/watermarks large enough never to bind reproduces ``run_fleet``'s
per-transfer results **bit-for-bit** (and exact totals bit-equal; only
percentiles carry the sketch tolerance) — tested in
tests/test_torch_fleet_online.py.  Host and device memory are functions of
``pool_capacity`` + ``queue_high``, never of stream length.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.api.scenario import resolve_device
from repro_torch.core import engine, tickstate
from repro_torch.distributed.sharding import MeshConfig
from repro_torch.kernels import tick_loop as tl

from . import scheduler
from .admission import (Combo, budget_steps, combo_key, make_transfer,
                        nic_shares, pick_host, resume_request)
from .aggregates import FleetFold, HostStats, OnlineFleetReport
from .arrivals import TransferRequest, replay_stream
from .hosts import Host
from .ringbuf import SlotPool


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Knobs for :func:`run_fleet_online` (Alpa-style options object).

    Scheduling quanta (``wave_s``, ``dt``), admission (``assignment``),
    the wave's lowering (``executor``) and the devices mean exactly what
    they do on ``run_fleet``.  The online-only knobs:

    * ``pool_capacity`` — max in-flight lanes **per wave-runner group**
      (per unique controller x environment x cpu x stride).  This, not the
      stream length, bounds slot-pool memory; a full pool queues further
      admissions.  With several devices it is rounded up to a multiple of
      the device count so each pool splits evenly.
    * ``max_partitions`` — static ``TickLayout`` width every lane is
      padded to (padding partitions are a bit-exact no-op).  A request
      whose datasets need more partitions than this raises at admission;
      raise the knob to match the workload's widest dataset tuple.  The
      tick kernel takes at most 8: above that, ask for
      ``executor="reference"`` (the plain wave loop).
    * ``queue_high`` / ``queue_low`` — ingest backpressure watermarks on
      the waiting queue (pause at high, resume at low).  Bounds queue
      memory; note a paused ingest *delays* arrivals relative to an
      offline run of the same trace, so parity runs want generous
      watermarks.
    * ``devices`` — the torch devices the pools run on (default: the CUDA
      device; ``("cpu",)`` for the plain wave loop on the CPU), or
      ``mesh`` — a :class:`repro_torch.distributed.sharding.MeshConfig`
      naming the cards; at most one of the two.
    * ``horizon_s`` — hard stop for the simulation clock (the way to bound
      a run on a never-ending stream); in-flight lanes retire incomplete,
      queued requests count as ``dropped``.
    * ``track_transfers`` — debug/parity knob: retain every per-transfer
      record (re-introducing O(n) memory) on the report, sorted like the
      offline report.
    * ``rel_err`` — the streaming quantile sketch's relative-error bound
      (documented tolerance on p50/p95/p99 vs. the offline percentiles).
    * ``on_wave`` — optional callable receiving a per-wave counters dict
      (queue depth, in-flight, admit/retire counts, recycled slots) for
      live observability; totals/peaks land in the report's ``counters``
      payload regardless.
    * ``faults`` — a :class:`repro_torch.workloads.faults.FaultSchedule`
      (host loss / NIC degradation / transfer kills) applied between waves
      at the same loop point as the offline scheduler, with killed
      transfers requeued through the shared ``resume_request`` path; adds
      a ``churn`` block to the report.
    * ``slo_s`` — per-request latency SLO: arms the fold's latency sketch
      and violation counter (``latency`` + ``slo`` summary blocks).
    """

    wave_s: float = 30.0
    dt: float = 0.1
    pool_capacity: int = 256
    max_partitions: int = 8
    queue_high: int = 10_000
    queue_low: int = 1_000
    assignment: str = "least-loaded"
    executor: str = "auto"
    devices: Optional[tuple] = None
    mesh: Optional[MeshConfig] = None
    horizon_s: Optional[float] = None
    track_transfers: bool = False
    rel_err: float = 0.01
    on_wave: Optional[Callable] = None
    faults: Optional[object] = None
    slo_s: Optional[float] = None

    def __post_init__(self):
        if self.pool_capacity < 1:
            raise ValueError(f"pool_capacity must be >= 1, got "
                             f"{self.pool_capacity}")
        if self.max_partitions < 1:
            raise ValueError(f"max_partitions must be >= 1, got "
                             f"{self.max_partitions}")
        if not 0 <= self.queue_low <= self.queue_high:
            raise ValueError(f"need 0 <= queue_low <= queue_high, got "
                             f"low={self.queue_low} high={self.queue_high}")
        if self.devices is not None:
            object.__setattr__(self, "devices", tuple(self.devices))
            if self.mesh is not None:
                raise ValueError("give OnlineConfig.devices or mesh, not "
                                 "both")


class _Peek:
    """One-item peek buffer over a request iterator (for idle
    fast-forward: the loop needs the next arrival time without consuming
    it)."""

    __slots__ = ("_it", "_buf", "_done")

    def __init__(self, it: Iterator[TransferRequest]):
        self._it = it
        self._buf = None
        self._done = False

    def peek(self) -> Optional[TransferRequest]:
        if self._buf is None and not self._done:
            self._buf = next(self._it, None)
            if self._buf is None:
                self._done = True
        return self._buf

    def pop(self) -> TransferRequest:
        req = self.peek()
        if req is None:
            raise StopIteration
        self._buf = None
        return req


def _devices_of(cfg: OnlineConfig) -> list:
    if cfg.mesh is not None:
        devices = list(cfg.mesh.devices())
    elif cfg.devices is None:
        devices = [resolve_device(None)]
    else:
        devices = [resolve_device(d) for d in cfg.devices]
    if not devices:
        raise ValueError("need at least one device")
    return devices


def run_fleet_online(stream: Iterable[TransferRequest],
                     hosts: Sequence[Host], *,
                     config: Optional[OnlineConfig] = None,
                     **overrides) -> OnlineFleetReport:
    """Run an arrival stream against a host pool with bounded memory.

    ``stream`` is any iterable of :class:`TransferRequest` in nondecreasing
    arrival order — the ``repro_torch.fleet.arrivals`` stream adapters, or
    a finite trace (validated through ``replay_stream`` either way).  Knobs
    come from ``config`` (an :class:`OnlineConfig`), with keyword
    ``overrides`` applied on top::

        report = run_fleet_online(
            diurnal_stream(base_rate_per_s=2.0, peak_rate_per_s=20.0,
                           period_s=86_400.0, datasets=menu,
                           controllers=("eemt", "me"), profile=CHAMELEON),
            host_pool(8), horizon_s=7 * 86_400.0, pool_capacity=512)

    runs on the card; pass ``devices=("cpu",)`` for the plain wave loop on
    the CPU.  ``executor`` is resolved for each device
    (``engine.resolve_executor``: ``auto`` is the kernel on a card and the
    plain loop on the CPU); ``cuda`` with ``max_partitions`` above the
    kernel's 8 raises before the first wave.  Returns an
    :class:`repro_torch.fleet.aggregates.OnlineFleetReport`; see the module
    docstring for the loop and its parity/memory contracts.
    """
    cfg = config or OnlineConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    hosts = tuple(hosts)
    if not hosts:
        raise ValueError("need at least one host")
    wave_steps = int(round(cfg.wave_s / cfg.dt))
    if wave_steps < 1:
        raise ValueError(f"wave_s={cfg.wave_s} shorter than dt={cfg.dt}")
    dt, wave_s = cfg.dt, cfg.wave_s
    devices = _devices_of(cfg)
    executors = [engine.resolve_executor(cfg.executor, d) for d in devices]
    if "cuda" in executors and cfg.max_partitions > tl.MAX_PARTITIONS:
        raise ValueError(
            f"OnlineConfig.max_partitions={cfg.max_partitions}: the CUDA "
            f"tick kernel takes at most {tl.MAX_PARTITIONS} partitions; "
            f"lower max_partitions or run the plain wave loop with "
            f"executor=\"reference\"")
    ndev = len(devices)
    capacity = -(-cfg.pool_capacity // ndev) * ndev

    lay = tickstate.TickLayout(cfg.max_partitions)
    combos: dict[tuple, Combo] = {}

    def combo_for(req: TransferRequest, host: Host) -> Combo:
        ck = combo_key(req, host)
        c = combos.get(ck)
        if c is None:
            c = Combo(req, host, dt)
            if c.n_partitions > cfg.max_partitions:
                raise ValueError(
                    f"request {req.name!r} needs {c.n_partitions} "
                    f"partitions but OnlineConfig.max_partitions="
                    f"{cfg.max_partitions}; raise the knob to the "
                    f"workload's widest dataset tuple")
            c.finalize(cfg.max_partitions)
            combos[ck] = c
        return c

    pools: dict[tuple, SlotPool] = {}
    fold = FleetFold(rel_err=cfg.rel_err, slo_s=cfg.slo_s)
    tracked: Optional[list] = [] if cfg.track_transfers else None
    faults = cfg.faults
    churn = faults.churn_fold() if faults is not None else None
    last_fault_s = -math.inf

    active = [0] * len(hosts)
    busy_waves = [0] * len(hosts)
    moved_mb = [0.0] * len(hosts)
    peak = [0] * len(hosts)
    rr = [0]
    seq = 0
    wave = 0
    waves_run = 0
    paused = False
    waiting: list[TransferRequest] = []
    admitted_total = 0
    retired_total = 0
    peak_queue = 0
    peak_in_flight = 0
    paused_waves = 0

    src = _Peek(iter(replay_stream(stream)))

    def fold_transfer(pool: SlotPool, slot: int) -> None:
        h = int(pool.host_idx[slot])
        name = pool.names[slot]
        t = make_transfer(
            lay, pool.f32[slot],
            name=name,
            controller=pool.ctrl_names[slot],
            host=hosts[h].name,
            arrival_s=float(pool.arrival_s[slot]),
            start_s=float(pool.start_s[slot]),
            steps_done=int(pool.steps_done[slot]),
            done_at=int(pool.done_at[slot]),
            dt=dt,
            ideal_s=float(pool.ideal_s[slot]),
        )
        fold.add(t)
        if churn is not None:
            churn.retire(name, attempt=pool.reqs[slot].attempt,
                         completed=t.completed,
                         offered_parts=pool.combos[slot].offered_parts,
                         remaining_parts=pool.f32[slot, :lay.n_partitions],
                         energy_j=t.energy_j)
        if tracked is not None:
            tracked.append(t)
        active[h] -= 1

    while True:
        now = wave * wave_s
        if cfg.horizon_s is not None and now >= cfg.horizon_s:
            break

        # -- ingest (backpressured) ----------------------------------- --
        if paused and len(waiting) <= cfg.queue_low:
            paused = False
        if paused:
            paused_waves += 1
        while not paused:
            nxt = src.peek()
            if nxt is None or nxt.arrival_s > now:
                break
            waiting.append(src.pop())
            if len(waiting) >= cfg.queue_high:
                paused = True
        peak_queue = max(peak_queue, len(waiting))

        # -- faults (same loop point and victim order as offline) ------ --
        down = frozenset()
        if faults is not None:
            down = faults.down_hosts(now, now + wave_s)
            kill_names = faults.kills_in(last_fault_s, now)
            last_fault_s = now
            victims = []
            for pool in pools.values():
                for slot in pool.active_slots():
                    slot = int(slot)
                    h = int(pool.host_idx[slot])
                    name = pool.names[slot]
                    if h in down:
                        victims.append((name, "host", pool, slot))
                    elif name in kill_names:
                        victims.append((name, "kill", pool, slot))
            victims.sort(key=lambda v: v[0])
            for name, kind, pool, slot in victims:
                req = pool.reqs[slot]
                combo = pool.combos[slot]
                rem = pool.f32[slot, :lay.n_partitions].copy()
                requeue = resume_request(req, name, combo.specs, rem,
                                         restart=faults.restart)
                churn.kill(name, kind=kind, attempt=req.attempt,
                           offered_parts=combo.offered_parts,
                           remaining_parts=rem,
                           energy_j=float(lay.energy_j(pool.f32[slot])),
                           requeued=requeue is not None)
                if requeue is not None:
                    waiting.append(requeue)
                active[int(pool.host_idx[slot])] -= 1
                pool.release(slot)

        # -- admit (FIFO, shared policy, slot from the group's pool) -- --
        admitted = 0
        still = []
        for req in waiting:
            h = pick_host(req, hosts, active, cfg.assignment, rr, down)
            if h is None:
                still.append(req)
                continue
            combo = combo_for(req, hosts[h])
            pool = pools.get(combo.key)
            if pool is None:
                pool = pools[combo.key] = SlotPool(capacity, lay)
            slot = pool.alloc()
            if slot is None:              # group pool full: keep waiting
                still.append(req)
                continue
            pool.params[slot] = combo.params_row
            pool.f32[slot] = combo.f0
            pool.i32[slot] = combo.i0
            pool.budget[slot] = budget_steps(req, dt)
            pool.host_idx[slot] = h
            pool.start_s[slot] = now
            pool.arrival_s[slot] = req.arrival_s
            pool.ideal_s[slot] = combo.ideal_s
            pool.demand_mbps[slot] = req.profile.bandwidth_mbps
            pool.names[slot] = req.name or f"xfer-{seq}"
            pool.ctrl_names[slot] = combo.ctrl_name
            pool.reqs[slot] = req
            pool.combos[slot] = combo
            seq += 1
            admitted += 1
            active[h] += 1
            peak[h] = max(peak[h], active[h])
        waiting = still
        admitted_total += admitted

        in_flight = sum(p.in_flight for p in pools.values())
        peak_in_flight = max(peak_in_flight, in_flight)
        if in_flight == 0:
            nxt = src.peek()
            if nxt is None and not waiting:
                break                      # drained: stream + queue empty
            if not waiting:
                # Idle gap: jump straight to the wave of the next arrival.
                wave = max(wave + 1,
                           int(math.ceil(nxt.arrival_s / wave_s)))
                continue
            wave += 1                      # queued but nothing admissible
            continue

        # -- rescale (shared NIC-share policy) ------------------------- --
        demand = [0.0] * len(hosts)
        for pool in pools.values():
            for slot in pool.active_slots():
                demand[int(pool.host_idx[slot])] += float(
                    pool.demand_mbps[slot])
        caps = (faults.nic_caps(hosts, now, now + wave_s)
                if faults is not None else None)
        share = np.asarray(nic_shares(hosts, demand, caps), np.float32)

        # -- one wave for every occupied pool (whole-capacity rows) ---- --
        run = []
        for key, pool in pools.items():
            if pool.in_flight == 0:
                continue
            act = pool.active_slots()
            np.put(pool.bw, act, share[pool.host_idx[act]])
            run.append((key, pool, act, pool.f32[act, lay.off_bytes].copy()))
        outs = scheduler.run_wave_rows(
            [(key, (pool.params, pool.bw, pool.f32, pool.i32,
                    pool.steps_done.copy())) for key, pool, _, _ in run],
            wave_steps, dt, devices, executors, lay)

        retired = 0
        hosts_active = set()
        for (_, pool, act, before), (f32o, i32o, done_w) in zip(run, outs):
            pool.f32 = f32o                # writable host copies: slots
            pool.i32 = i32o                # are mutated in place on
            pool.steps_done[act] += wave_steps   # release/admit
            fresh = act[pool.done_at[act] < 0]
            pool.done_at[fresh] = done_w[fresh]

            for slot, b in zip(act, before):
                h = int(pool.host_idx[slot])
                moved_mb[h] += float(pool.f32[slot, lay.off_bytes]) - float(b)
                hosts_active.add(h)
            rem = pool.f32[act, :lay.n_partitions].sum(axis=1)
            exhausted = pool.steps_done[act] >= pool.budget[act]
            for slot in act[(rem <= 0.0) | exhausted]:
                fold_transfer(pool, int(slot))
                pool.release(int(slot))
                retired += 1
        retired_total += retired
        for h in hosts_active:
            busy_waves[h] += 1
        waves_run += 1

        if cfg.on_wave is not None:
            cfg.on_wave({
                "wave": wave, "now": now, "queue_depth": len(waiting),
                "in_flight": in_flight, "admitted": admitted,
                "retired": retired, "ingest_paused": paused,
                "recycled": sum(p.recycled for p in pools.values()),
            })
        wave += 1

    # Horizon cut (or pool drain on break): in-flight lanes retire
    # incomplete, exactly like the offline scheduler's epilogue.
    for pool in pools.values():
        for slot in pool.active_slots():
            fold_transfer(pool, int(slot))
            pool.release(int(slot))
    dropped = len(waiting)
    if churn is not None:
        churn.finalize()

    if tracked is not None:
        tracked.sort(key=lambda t: (t.start_s, t.name))

    counters = {
        "admitted": admitted_total,
        "retired": retired_total,
        "recycled_slots": sum(p.recycled for p in pools.values()),
        "peak_queue_depth": peak_queue,
        "peak_in_flight": peak_in_flight,
        "peak_pool_in_flight": max(
            (p.peak_in_flight for p in pools.values()), default=0),
        "ingest_paused_waves": paused_waves,
        "pools": len(pools),
        "pool_capacity": capacity,
        "waves_run": waves_run,
        "admit_rate_per_wave": admitted_total / max(waves_run, 1),
        "retire_rate_per_wave": retired_total / max(waves_run, 1),
    }
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
    return OnlineFleetReport(
        fold=fold, host_stats=stats, sim_s=wave * wave_s, waves=waves_run,
        wave_s=wave_s, dt=dt, dropped=dropped, counters=counters,
        transfers=tuple(tracked) if tracked is not None else None,
        churn=churn.report() if churn is not None else None)
