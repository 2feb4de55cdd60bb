"""Core datatypes for the SLA-driven transfer-tuning framework (PyTorch).

Static (hashable) config dataclasses describe testbeds, CPUs, datasets and
SLAs; NamedTuples of tensors carry the per-tick state.  Every state tensor
has a leading *lane* axis (one lane per simulated transfer) where the JAX
package used ``vmap``: a ``SimState`` of a batch of ``B`` transfers holds
``remaining_mb`` of shape ``[B, P]`` and ``t`` of shape ``[B]``.  The same
NamedTuples also hold host-side numpy leaves (one transfer, no lane axis)
between controller ``init`` and the engine.

Units convention (internal):
    bytes   -> MB (float32)
    time    -> seconds
    rate    -> MB/s
    power   -> watts
    energy  -> joules
    freq    -> GHz
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import NamedTuple

import numpy as np
import torch

MB = 1.0
GB = 1024.0
KB = 1.0 / 1024.0


class SLAPolicy(enum.IntEnum):
    """Service-level agreement requested by the client (paper §IV)."""

    MIN_ENERGY = 0          # ME   (Algorithm 4)
    MAX_THROUGHPUT = 1      # EEMT (Algorithm 5)
    TARGET_THROUGHPUT = 2   # EETT (Algorithm 6)
    ISMAIL_TARGET = 3       # baseline: Ismail et al. target tuner (§V-B) —
                            # starts at 1 channel, +/-1 per tick, static
                            # channel distribution, no freq/core scaling


@dataclasses.dataclass(frozen=True)
class SLA:
    """SLA + tuner hyper-parameters (α, β, Δch, timeout of Algorithms 4-6)."""

    policy: SLAPolicy = SLAPolicy.MAX_THROUGHPUT
    target_tput_mbps: float = 0.0      # only for TARGET_THROUGHPUT, MB/s
    alpha: float = 0.10                # negative-feedback tolerance
    beta: float = 0.05                 # positive-feedback threshold
    delta_ch: int = 2                  # ΔCh channel increment
    max_ch: int = 64                   # maxCh
    timeout_s: float = 1.0             # controller tick ("Timeout")
    max_load: float = 0.85             # Algorithm 3 maxLoad
    min_load: float = 0.40             # Algorithm 3 minLoad


@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    """A testbed network (paper Table I)."""

    name: str = "chameleon"
    bandwidth_mbps: float = 1250.0       # 10 Gbps
    rtt_s: float = 0.032
    avg_window_mb: float = 2.0           # average TCP window (iperf estimate)
    buffer_mb: float = 4.0               # socket buffer size
    loss_knee: float = 1.35              # over-concurrency contention knee
    cross_traffic: float = 0.0           # fraction of bandwidth stolen (0..1)

    @property
    def bdp_mb(self) -> float:
        return self.bandwidth_mbps * self.rtt_s


@dataclasses.dataclass(frozen=True)
class CpuProfile:
    """End-system host CPU (the paper's Haswell/Broadwell clients)."""

    name: str = "haswell"
    num_cores: int = 8
    freq_levels_ghz: tuple = (1.2, 1.5, 1.8, 2.1, 2.4, 2.7, 3.0)
    ipc: float = 1.6                      # sustained instructions/cycle
    cycles_per_byte: float = 14.0         # protocol+copy cost of the transfer path
    cycles_per_byte_per_ch: float = 0.08  # per-extra-channel overhead
    pkg_static_w: float = 6.0             # package uncore/idle power
    core_static_w: float = 1.0            # per awake core (leakage)
    core_dyn_w_per_ghz3: float = 0.55     # ~15 W/core at 3 GHz full load
    mem_w_per_mbps: float = 0.004         # DRAM power ~ bytes moved

    @property
    def min_freq(self) -> float:
        return self.freq_levels_ghz[0]

    @property
    def max_freq(self) -> float:
        return self.freq_levels_ghz[-1]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """A file partition (paper Table II row). Static metadata."""

    name: str
    num_files: int
    total_mb: float
    avg_file_mb: float
    std_file_mb: float = 0.0


# Canonical paper datasets (Table II).
SMALL_FILES = DatasetSpec("small", 20_000, 1.94 * GB, 101.92 * KB, 29.06 * KB)
MEDIUM_FILES = DatasetSpec("medium", 5_000, 11.70 * GB, 2.40, 0.27)
LARGE_FILES = DatasetSpec("large", 128, 27.85 * GB, 222.78, 15.19)
MIXED = (SMALL_FILES, MEDIUM_FILES, LARGE_FILES)

# Canonical paper testbeds (Table I).
CHAMELEON = NetworkProfile("chameleon", 1250.0, 0.032, avg_window_mb=2.5, buffer_mb=8.0)
CLOUDLAB = NetworkProfile("cloudlab", 125.0, 0.036, avg_window_mb=1.0, buffer_mb=2.0)
DIDCLAB = NetworkProfile("didclab", 125.0, 0.044, avg_window_mb=1.0, buffer_mb=2.0)
TESTBEDS = {"chameleon": CHAMELEON, "cloudlab": CLOUDLAB, "didclab": DIDCLAB}


class NetParams(NamedTuple):
    """Numeric view of a :class:`NetworkProfile`: one float32 per field
    (host ``np.float32``, or a ``[B]`` tensor for a lane batch)."""

    bandwidth_mbps: object
    rtt_s: object
    avg_window_mb: object
    buffer_mb: object
    loss_knee: object
    cross_traffic: object

    @property
    def bdp_mb(self):
        return self.bandwidth_mbps * self.rtt_s

    @classmethod
    def from_profile(cls, profile: "NetworkProfile") -> "NetParams":
        return cls(*[np.float32(getattr(profile, f)) for f in cls._fields])


class SLAParams(NamedTuple):
    """Numeric view of an :class:`SLA` (the hyper-parameters that vary
    across a lane batch).  ``policy`` and ``timeout_s`` stay static: the
    former selects code, the latter sets the controller-tick stride."""

    target_tput_mbps: object
    alpha: object
    beta: object
    delta_ch: object
    max_ch: object
    max_load: object
    min_load: object

    @classmethod
    def from_sla(cls, sla: "SLA") -> "SLAParams":
        return cls(*[np.float32(getattr(sla, f)) for f in cls._fields])


class TransferParams(NamedTuple):
    """The five jointly-tuned application-level parameters (paper §II)."""

    pp: object        # [..., P] pipelining depth per partition (float)
    par: object       # [..., P] parallelism (chunks/file) per partition
    cc: object        # [..., P] concurrent channels per partition
    cores: object     # [...] active core count (int32)
    freq_idx: object  # [...] index into freq_levels_ghz (int32)


class SimState(NamedTuple):
    """Dynamic state of the discrete-time transfer simulation (frozen by
    the engine at the completion tick)."""

    remaining_mb: object   # [..., P] bytes left per partition
    window_mb: object      # [..., P] current avg TCP window per channel
    t: object              # [...] elapsed seconds (frozen at completion)
    energy_j: object       # [...] cumulative energy (frozen at completion)
    bytes_moved: object    # [...] cumulative MB


class TunerState(NamedTuple):
    """State of the FSM controller (Algorithms 4-6) + load control."""

    fsm: object            # [...] int32 FSM state
    num_ch: object         # [...] float32 total channel budget
    prev_num_ch: object    # [...] float32 (for Recovery restore)
    ref: object            # [...] float32 refTput (EEMT) / E_past (ME)
    cores: object          # [...] int32
    freq_idx: object       # [...] int32
    acc_mb: object         # [...] float32 accumulators since the last tick
    acc_j: object
    acc_s: object


class TickMetrics(NamedTuple):
    """Per-tick observables, ``[B, n_steps]`` per field.

    ``done[:, i]`` is recorded *after* tick ``i``: it is True from the tick
    during which the transfer drained (completion time ``(i + 1) * dt``).
    All other fields are zero on post-completion ticks.
    """

    tput_mbps: object
    power_w: object
    cpu_load: object
    num_ch: object
    cores: object
    freq_ghz: object
    done: object


@functools.lru_cache(maxsize=None)
def _freq_table(levels: tuple, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(levels, np.float32), device=device)


def freq_table(cpu: CpuProfile, device=None) -> torch.Tensor:
    """The CPU's frequency ladder as a float32 tensor on ``device`` (cached
    per ladder and device, so the eager tick loop does not re-upload it)."""
    return _freq_table(tuple(cpu.freq_levels_ghz), torch.device(device or "cpu"))


def host_tensors(nt):
    """A NamedTuple of host scalars as 0-d CPU tensors (the tuner's state
    and parameters when it runs as host control logic: continuous-batching
    admission, the tuned fetcher)."""
    return type(nt)(*[torch.as_tensor(np.asarray(v)) for v in nt])
