"""Fixed-capacity, ring-buffered slot pools for online fleet lanes (the
port of ``repro/fleet/ringbuf.py``, host numpy as there).

The offline scheduler keeps one mutable ``_Lane`` object per in-flight
transfer and re-stacks them into a wave batch every wave.  The online
loop (``repro_torch.fleet.online``) cannot afford either: an unbounded
arrival stream means an unbounded number of lanes over the run's
lifetime, and per-wave restacking means per-occupancy batch shapes.  A
:class:`SlotPool` fixes both at once:

* **Bounded memory.**  All lane state lives in preallocated arrays of a
  fixed ``capacity`` — the two flat ``TickLayout`` state rows, the shared
  parameter row, and the scalar per-lane bookkeeping (step counters, tick
  budgets, host indices, timestamps).  Host memory is a function of
  ``capacity``, never of how many transfers the stream has carried.
* **Stable shapes.**  The *whole pool* is the wave batch: every wave runs
  the pool's ``[capacity, ...]`` arrays, occupied or not (on a card, every
  occupied pool of the wave in one launch of the tick kernel's wave mode).
  Free slots hold zeroed state rows — a zeroed lane has no bytes
  remaining, so the kernel never ticks it (the plain wave loop's
  accumulators of such a row come out NaN, as the JAX package's do; only
  active slots are ever read).
* **Recycling in place.**  Retired slots return to a FIFO free ring
  (oldest-freed reused first) and the next admission overwrites their rows
  in place; nothing is ever appended or reallocated.

Invariants (property-tested in tests/test_torch_ringbuf.py): a slot is
never handed out twice without an intervening :meth:`release`, occupancy
never exceeds ``capacity`` (:meth:`alloc` returns ``None`` when full), and
the free ring plus the active set always partition ``range(capacity)``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import tickstate


class SlotPool:
    """Preallocated lane storage for one wave-runner group.

    One pool exists per (controller code, environment code, cpu, stride)
    group — the same grouping the offline scheduler batches by — so every
    slot of a pool is shape- and code-compatible with its wave runner.
    """

    __slots__ = ("capacity", "layout", "params", "bw", "f32", "i32",
                 "steps_done", "done_at", "budget", "host_idx", "start_s",
                 "arrival_s", "ideal_s", "demand_mbps", "names",
                 "ctrl_names", "reqs", "combos", "_active", "_free",
                 "_free_head", "_free_tail", "in_flight", "peak_in_flight",
                 "recycled", "total_allocs")

    def __init__(self, capacity: int, layout: tickstate.TickLayout):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        c = int(capacity)
        self.capacity = c
        self.layout = layout
        self.params = np.zeros((c, layout.params_size), np.float32)
        self.bw = np.ones((c,), np.float32)
        self.f32 = np.zeros((c, layout.f32_size), np.float32)
        self.i32 = np.zeros((c, layout.i32_size), np.int32)
        self.steps_done = np.zeros((c,), np.int32)
        self.done_at = np.full((c,), -1, np.int32)
        self.budget = np.zeros((c,), np.int32)
        self.host_idx = np.full((c,), -1, np.int32)
        self.start_s = np.zeros((c,), np.float64)
        self.arrival_s = np.zeros((c,), np.float64)
        self.ideal_s = np.zeros((c,), np.float64)
        self.demand_mbps = np.zeros((c,), np.float64)
        self.names: list = [None] * c
        self.ctrl_names: list = [None] * c
        # References, not copies: the admitted TransferRequest and its
        # shared Combo — what fault injection reads to build the requeue
        # (remaining-bytes resume) and the churn ledger's offered
        # components.  Still O(capacity) memory.
        self.reqs: list = [None] * c
        self.combos: list = [None] * c
        self._active = np.zeros((c,), bool)
        # FIFO free ring: a fixed [capacity] index buffer with head/tail
        # counters (mod capacity).  Freed slots enqueue at the tail, alloc
        # dequeues at the head — the "ring" in ring-buffered.
        self._free = np.arange(c, dtype=np.int32)
        self._free_head = 0
        self._free_tail = 0          # == head + free_count (mod tracking
        self.in_flight = 0           # via in_flight instead)
        self.peak_in_flight = 0
        self.recycled = 0            # allocations that reused a freed slot
        self.total_allocs = 0

    # ------------------------------------------------------- alloc/free --

    def alloc(self) -> "int | None":
        """Claim a free slot (FIFO recycling order), or None when full.

        The slot's state rows are the zeros :meth:`release` left (or the
        pool was born with); the caller overwrites them with the admitted
        lane's combo rows and bookkeeping.
        """
        if self.in_flight >= self.capacity:
            return None
        slot = int(self._free[self._free_head % self.capacity])
        self._free_head += 1
        self._active[slot] = True
        self.in_flight += 1
        self.peak_in_flight = max(self.peak_in_flight, self.in_flight)
        self.total_allocs += 1
        if self.total_allocs > self.capacity:
            self.recycled += 1
        return slot

    def release(self, slot: int) -> None:
        """Retire a slot: zero its rows (a zeroed lane is born drained, so
        the pool-wide wave run freezes it from tick 0) and enqueue it on
        the free ring for reuse."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._active[slot] = False
        self.params[slot] = 0.0
        self.bw[slot] = 1.0
        self.f32[slot] = 0.0
        self.i32[slot] = 0
        self.steps_done[slot] = 0
        self.done_at[slot] = -1
        self.budget[slot] = 0
        self.host_idx[slot] = -1
        self.start_s[slot] = 0.0
        self.arrival_s[slot] = 0.0
        self.ideal_s[slot] = 0.0
        self.demand_mbps[slot] = 0.0
        self.names[slot] = None
        self.ctrl_names[slot] = None
        self.reqs[slot] = None
        self.combos[slot] = None
        self._free[self._free_tail % self.capacity] = slot
        self._free_tail += 1
        self.in_flight -= 1

    # ------------------------------------------------------------ views --

    def active_slots(self) -> np.ndarray:
        """Indices of occupied slots, ascending (deterministic iteration
        order for retirement and aggregation)."""
        return np.flatnonzero(self._active)

    def is_active(self, slot: int) -> bool:
        return bool(self._active[slot])
