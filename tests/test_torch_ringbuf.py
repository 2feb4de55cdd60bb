"""repro_torch.fleet.ringbuf.SlotPool against the JAX package's SlotPool.

tests/test_ringbuf.py's SlotPool properties (the same hypothesis strategy)
with the same alloc/release sequence applied to both packages' pools: the
same slots come out, the same counters, and the port's pool keeps every
invariant on its own (no slot handed out twice, capacity never exceeded,
the free ring and the active set partitioning ``range(capacity)``, a
released slot's rows zeroed).  The streaming aggregates (``ExactSum``,
``QuantileSketch``) are held to JAX's in tests/test_torch_fleet_aggregates.py.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import tickstate as jtickstate
from repro.fleet.ringbuf import SlotPool as JSlotPool
from repro_torch.core import tickstate
from repro_torch.fleet.ringbuf import SlotPool

LAY = tickstate.TickLayout(2)
JLAY = jtickstate.TickLayout(2)
COUNTERS = ("in_flight", "peak_in_flight", "recycled", "total_allocs")


def counters(pool):
    return tuple(getattr(pool, k) for k in COUNTERS)


@settings(max_examples=60, deadline=None)
@given(capacity=st.integers(1, 9),
       ops=st.lists(st.integers(0, 2 ** 30), min_size=1, max_size=120))
def test_slot_pool_invariants_and_jax_parity(capacity, ops):
    """Random alloc/release interleavings, on both packages' pools: equal
    slots and counters; no aliasing, no over-capacity, free + active
    always a partition of range(capacity), released rows zeroed."""
    pool, jpool = SlotPool(capacity, LAY), JSlotPool(capacity, JLAY)
    live = set()
    for op in ops:
        if op % 2 == 0 or not live:           # alloc
            slot, jslot = pool.alloc(), jpool.alloc()
            assert slot == jslot
            if len(live) == capacity:
                assert slot is None            # capacity never exceeded
            else:
                assert slot is not None and slot not in live  # no aliasing
                assert 0 <= slot < capacity
                pool.f32[slot, 0] = 1.0        # mark: release must zero it
                pool.params[slot, 0] = 2.0
                pool.names[slot] = f"x{op}"
                live.add(slot)
        else:                                  # release a random live slot
            slot = sorted(live)[op % len(live)]
            pool.release(slot)
            jpool.release(slot)
            live.remove(slot)
            assert pool.f32[slot].sum() == 0.0  # zeroed on retire
            assert pool.params[slot].sum() == 0.0
            assert pool.names[slot] is None and pool.bw[slot] == 1.0
        assert pool.in_flight == len(live)
        assert set(pool.active_slots().tolist()) == live
        assert np.array_equal(pool.active_slots(), jpool.active_slots())
        assert counters(pool) == counters(jpool)
        free = [int(pool._free[(pool._free_head + k) % capacity])
                for k in range(capacity - pool.in_flight)]
        assert sorted(free + sorted(live)) == list(range(capacity))
    assert pool.peak_in_flight <= capacity
    # total recycles = allocations beyond the first use of each slot
    assert pool.recycled == max(pool.total_allocs - capacity, 0)


def test_slot_pool_release_inactive_raises():
    pool = SlotPool(2, LAY)
    with pytest.raises(ValueError):
        pool.release(0)
    with pytest.raises(ValueError):
        SlotPool(0, LAY)


def test_slot_pool_fifo_recycling():
    """Freed slots are reused oldest-first (deterministic layout), as in
    the JAX package's pool."""
    pool, jpool = SlotPool(3, LAY), JSlotPool(3, JLAY)
    got = []
    for p in (pool, jpool):
        a, b, c = p.alloc(), p.alloc(), p.alloc()
        p.release(b)
        p.release(a)
        got.append((a, b, c, p.alloc(), p.alloc(), p.alloc()))
    assert got[0] == got[1] == (0, 1, 2, 1, 0, None)


def test_slot_pool_rows_follow_the_tick_layout():
    """The pool's arrays have the shapes and dtypes of the JAX package's
    pool over the same layout (rows of the port's TickLayout)."""
    pool, jpool = SlotPool(5, tickstate.TickLayout(8)), \
        JSlotPool(5, jtickstate.TickLayout(8))
    for name in ("params", "bw", "f32", "i32", "steps_done", "done_at",
                 "budget", "host_idx", "start_s", "arrival_s", "ideal_s",
                 "demand_mbps"):
        a, b = getattr(pool, name), getattr(jpool, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
