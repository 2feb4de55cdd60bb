"""End-system host model for fleet simulation.

A :class:`Host` is an end system transfers run *on*: a CPU profile (the
operating point every transfer's controller tunes within), an
``environment`` (the physics pair — NetworkModel + EnergyModel — its
transfers simulate under, see ``repro_torch.api.environments``), a
transfer-slot budget (admission control — the host's core budget expressed
as how many concurrent transfer processes it will run), and a shared NIC.

The NIC is the contention point: when the per-flow bandwidth demands of a
host's in-flight transfers exceed ``nic_mbps``, every transfer on that host
has its available bandwidth rescaled proportionally for the next wave (see
``repro_torch.fleet.scheduler``).  When total demand fits, transfers run
exactly as they would alone — the zero-contention fleet path is
bit-identical to independent ``api.run`` calls.

Heterogeneous pools mix hosts with different CPUs *and* different
environments (a lossy-WAN satellite site next to a clean-path datacenter,
big.LITTLE edge boxes next to Haswell servers); the scheduler groups wave
lanes by (controller code, environment code, cpu), so each distinct physics
is a lane batch of its own (on a card, one group of the wave's one kernel
launch) and lanes still batch within it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.types import CpuProfile


@dataclasses.dataclass(frozen=True)
class Host:
    """One end system in the fleet pool.

    ``slots`` caps concurrent transfers (0 = unlimited): arrivals beyond it
    queue in the scheduler until a slot frees.  This is the host's
    core/frequency budget in admission form — each transfer's controller
    still picks its own operating point inside the engine, but the host
    bounds how many such processes it multiplexes.

    ``environment`` accepts anything ``repro_torch.api.as_environment``
    does — ``None`` (the reference physics), an Environment instance, or a
    registry name ("lossy-wan", "big-little", ...).  Every transfer the
    scheduler places on this host simulates under it.
    """

    name: str
    nic_mbps: float = 1250.0          # shared NIC capacity (MB/s)
    cpu: CpuProfile = CpuProfile()
    slots: int = 0
    environment: Optional[Any] = None  # None -> reference physics

    def __post_init__(self):
        if self.nic_mbps <= 0:
            raise ValueError(f"nic_mbps must be positive, got {self.nic_mbps}")
        if self.slots < 0:
            raise ValueError(f"slots must be >= 0, got {self.slots}")


def host_pool(n: int, *, nic_mbps: float = 1250.0,
              cpu: CpuProfile = CpuProfile(), slots: int = 0,
              environment: Optional[Any] = None,
              name_prefix: str = "host") -> tuple[Host, ...]:
    """A homogeneous pool of ``n`` hosts (the common benchmark shape)."""
    if n <= 0:
        raise ValueError(f"need at least one host, got {n}")
    return tuple(Host(name=f"{name_prefix}-{i}", nic_mbps=nic_mbps,
                      cpu=cpu, slots=slots, environment=environment)
                 for i in range(n))
