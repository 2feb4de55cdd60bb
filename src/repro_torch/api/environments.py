"""The Environment protocol: pluggable physics for the transfer engine.

An :class:`Environment` bundles two protocol objects:

  * :class:`NetworkModel` — the per-tick WAN simulator.  ``step`` advances
    one tick of a lane batch (it receives the active :class:`EnergyModel`
    so CPU capacity / power always come from the environment's energy
    physics); ``init_state`` builds the tick-0 :class:`SimState`.
  * :class:`EnergyModel` — the host power model.  ``operating_point`` /
    ``cpu_capacity_mbps`` / ``cpu_load`` map an integer operating point to
    achievable throughput, and ``power_w`` is the instantaneous package
    draw the engine integrates into ``energy_j``.

``code()`` returns the hashable instance that selects the code a lane batch
runs: the engine groups scenarios by (controller code, environment code,
cpu, shape).

String registries parallel ``make_controller``::

    make_network_model("lossy-wan", loss_rate=1e-3)
    make_energy_model("big-little", n_big=2)
    make_environment("dvfs", tech="lp", idle="race")
    make_environment("logfit", log=[...])

Built-in variants, the JAX package's, each spelled out by the CUDA tick
kernel as well (``executor="auto"`` runs every one of them there):

  * ``reference`` — the paper's calibrated models (``repro_torch.core``
    ``network_model`` / ``energy_model``);
  * ``lossy-wan`` — a Mathis-style loss-rate cap on the per-channel TCP
    window, a sharper over-concurrency knee and a sinusoidal RTT jitter;
  * ``big-little`` — an asymmetric host CPU: cores past ``n_big`` are
    efficiency cores with a fraction of a big core's throughput and power;
  * ``dvfs`` — first-principles DVFS host physics
    (:mod:`repro_torch.core.dvfs`): V(f) tables, CV²f dynamic power,
    leakage, race-to-idle vs pace-to-deadline;
  * ``logfit`` — a bandwidth schedule (and RTT) fitted from a transfer log
    (:mod:`repro_torch.workloads.logfit`), registered lazily.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import energy_model, network_model
from repro_torch.core._f32 import ftz
from repro_torch.core.dvfs import (DvfsEnergyModel, DvfsNetworkModel,
                                   core_mix, mixed_capacity_mbps)
from repro_torch.core.types import CpuProfile, SimState

from ._registry import make_from, register_in


@runtime_checkable
class EnergyModel(Protocol):
    """Host power physics: operating point -> capacity, load, and watts."""

    name: str

    def code(self) -> "EnergyModel":
        """Hashable instance selecting the code a batch runs."""
        ...

    def operating_point(self, cpu: CpuProfile, cores, freq_idx):
        """(cores, f_GHz) from an integer operating point."""
        ...

    def cpu_capacity_mbps(self, cpu: CpuProfile, cores, freq_ghz, num_ch):
        """Max throughput (MB/s) the CPU can push at this operating point."""
        ...

    def cpu_load(self, cpu: CpuProfile, tput_mbps, cores, freq_ghz, num_ch):
        """Fraction of available CPU consumed by the transfer, in [0, 1]."""
        ...

    def power_w(self, cpu: CpuProfile, cores, freq_ghz, util, tput_mbps):
        """Instantaneous package power draw (W)."""
        ...


@runtime_checkable
class NetworkModel(Protocol):
    """Per-tick WAN physics: (state, params) -> (state', observables)."""

    name: str

    def code(self) -> "NetworkModel":
        """Hashable instance selecting the code a batch runs."""
        ...

    def init_state(self, total_mb, net) -> SimState:
        """Tick-0 simulation state."""
        ...

    def step(self, energy: EnergyModel, net, cpu: CpuProfile,
             state: SimState, params, avg_file_mb, dt, bw_scale):
        """Advance one tick.  ``energy`` is the environment's EnergyModel —
        all CPU capacity/power must come from it.  Returns (state', NetOut).
        """
        ...


@dataclasses.dataclass(frozen=True)
class ReferenceEnergyModel:
    """The paper's RAPL-calibrated model (``repro_torch.core.energy_model``)."""

    name = "reference"

    def code(self) -> "ReferenceEnergyModel":
        return self

    def operating_point(self, cpu, cores, freq_idx):
        return energy_model.operating_point(cpu, cores, freq_idx)

    def cpu_capacity_mbps(self, cpu, cores, freq_ghz, num_ch):
        return energy_model.cpu_capacity_mbps(cpu, cores, freq_ghz, num_ch)

    def cpu_load(self, cpu, tput_mbps, cores, freq_ghz, num_ch):
        return energy_model.cpu_load(cpu, tput_mbps, cores, freq_ghz, num_ch)

    def power_w(self, cpu, cores, freq_ghz, util, tput_mbps):
        return energy_model.power_w(cpu, cores, freq_ghz, util, tput_mbps)


@dataclasses.dataclass(frozen=True)
class ReferenceNetworkModel:
    """The paper's deterministic WAN simulator
    (``repro_torch.core.network_model``)."""

    name = "reference"

    def code(self) -> "ReferenceNetworkModel":
        return self

    def init_state(self, total_mb, net) -> SimState:
        return network_model.init_state(total_mb, net)

    def step(self, energy, net, cpu, state, params, avg_file_mb, dt,
             bw_scale):
        return network_model.step(net, cpu, state, params, avg_file_mb, dt,
                                  bw_scale, energy=energy)


# Mathis et al.: steady-state TCP throughput <= C * MSS / (RTT * sqrt(p)),
# as a cap on the effective congestion window: w_loss = C * MSS / sqrt(p).
_MATHIS_C = 1.22
_MSS_MB = 1500.0 / (1024.0 * 1024.0)
_KNEE_GAIN = 4.0


@dataclasses.dataclass(frozen=True)
class LossyWanNetworkModel:
    """A lossy wide-area path, still deterministic: the reference step on
    transformed network parameters.

    * **Loss-rate window cap** ``1.22 * MSS / sqrt(loss_rate)``;
    * **sharper over-concurrency knee**: ``loss_knee / (1 + 4 *
      sqrt(loss_rate))``;
    * **RTT jitter** ``rtt * (1 + jitter_frac * sin(2 pi t / period))``, a
      pure function of the lane's simulated time.

    Each constant is the float32 rounding of the JAX package's Python
    double expression; nothing is applied when ``loss_rate`` or
    ``jitter_frac`` is 0."""

    name = "lossy-wan"
    loss_rate: float = 1e-4        # steady packet-loss probability
    jitter_frac: float = 0.1       # peak RTT deviation (fraction)
    jitter_period_s: float = 60.0  # jitter oscillation period

    def __post_init__(self):
        if self.loss_rate < 0.0:
            raise ValueError(f"loss_rate must be >= 0, got {self.loss_rate}")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1), got "
                             f"{self.jitter_frac}")
        if self.jitter_period_s <= 0.0:
            raise ValueError(f"jitter_period_s must be positive, got "
                             f"{self.jitter_period_s}")

    def code(self) -> "LossyWanNetworkModel":
        return self

    def jitter_rate(self) -> float:
        """The jitter's angular rate ``2 pi / period`` (rad/s)."""
        return 2.0 * math.pi / self.jitter_period_s

    def window_cap(self) -> float:
        """The Mathis window cap ``w_loss`` (MB)."""
        return _MATHIS_C * _MSS_MB / math.sqrt(self.loss_rate)

    def knee_divisor(self) -> float:
        return 1.0 + _KNEE_GAIN * math.sqrt(self.loss_rate)

    def init_state(self, total_mb, net) -> SimState:
        return network_model.init_state(total_mb, net)

    def step(self, energy, net, cpu, state, params, avg_file_mb, dt,
             bw_scale):
        rtt = net.rtt_s
        if self.jitter_frac > 0.0:
            phase = ftz(self.jitter_rate() * state.t)
            rtt = ftz(rtt * ftz(1.0 + ftz(self.jitter_frac
                                          * ftz(torch.sin(phase)))))
        window = net.avg_window_mb
        knee = net.loss_knee
        if self.loss_rate > 0.0:
            window = torch.minimum(window, torch.full_like(
                window, np.float32(self.window_cap())))
            knee = ftz(torch.div(knee, torch.full_like(
                knee, np.float32(self.knee_divisor()))))
        net = net._replace(rtt_s=rtt, avg_window_mb=window, loss_knee=knee)
        return network_model.step(net, cpu, state, params, avg_file_mb, dt,
                                  bw_scale, energy=energy)


@dataclasses.dataclass(frozen=True)
class BigLittleEnergyModel:
    """Asymmetric-core (big.LITTLE-style) host CPU.

    The first ``n_big`` awake cores are big cores with the reference
    per-core throughput and power; cores past them deliver ``little_perf``
    of a big core's throughput at ``little_dyn_frac`` of its dynamic and
    ``little_static_frac`` of its static power.  With ``n_big >=
    cpu.num_cores`` it is the reference model bit for bit.  The frequency
    ladder is shared (cluster DVFS)."""

    name = "big-little"
    n_big: int = 4
    little_perf: float = 0.45        # little-core throughput / big-core
    little_dyn_frac: float = 0.25    # little-core dynamic power / big-core
    little_static_frac: float = 0.5  # little-core leakage / big-core

    def __post_init__(self):
        if self.n_big < 1:
            raise ValueError(f"n_big must be >= 1, got {self.n_big}")
        for f in ("little_perf", "little_dyn_frac", "little_static_frac"):
            v = getattr(self, f)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{f} must be in (0, 1], got {v}")

    def code(self) -> "BigLittleEnergyModel":
        return self

    def operating_point(self, cpu, cores, freq_idx):
        return energy_model.operating_point(cpu, cores, freq_idx)

    def cpu_capacity_mbps(self, cpu, cores, freq_ghz, num_ch):
        return mixed_capacity_mbps(cpu, cores, freq_ghz, num_ch, self.n_big,
                                   self.little_perf)

    def cpu_load(self, cpu, tput_mbps, cores, freq_ghz, num_ch):
        cap = self.cpu_capacity_mbps(cpu, cores, freq_ghz, num_ch)
        return torch.clamp(ftz(tput_mbps / cap.clamp_min(1e-6)), 0.0, 1.0)

    def power_w(self, cpu, cores, freq_ghz, util, tput_mbps):
        big, little = core_mix(cores, self.n_big)
        u = torch.clamp(util, 0.0, 1.0)
        f3 = ftz(ftz(freq_ghz * freq_ghz) * freq_ghz)
        dyn = ftz(ftz(ftz(ftz(big + ftz(little * self.little_dyn_frac))
                          * cpu.core_dyn_w_per_ghz3) * f3) * u)
        static = ftz(cpu.pkg_static_w
                     + ftz(ftz(big + ftz(little * self.little_static_frac))
                           * cpu.core_static_w))
        mem = ftz(cpu.mem_w_per_mbps * tput_mbps)
        return ftz(ftz(static + dyn) + mem)


@dataclasses.dataclass(frozen=True)
class Environment:
    """One testbed physics: a NetworkModel + an EnergyModel, frozen and
    hashable (it joins the sweep group key)."""

    network: Any = ReferenceNetworkModel()
    energy: Any = ReferenceEnergyModel()

    @property
    def name(self) -> str:
        if self.network.name == self.energy.name:
            return self.network.name
        return f"{self.network.name}+{self.energy.name}"

    def code(self) -> "Environment":
        return Environment(network=self.network.code(),
                           energy=self.energy.code())


REFERENCE_ENV = Environment()


# -------------------------------------------------------------- registries --

_NETWORK_REGISTRY: dict[str, Callable[..., NetworkModel]] = {}
_ENERGY_REGISTRY: dict[str, Callable[..., EnergyModel]] = {}
_ENV_REGISTRY: dict[str, Callable[..., Environment]] = {}


def register_network_model(name: str, factory: Callable[..., NetworkModel],
                           *, overwrite: bool = False) -> None:
    """Register a network-model factory under ``name`` (case-insensitive)."""
    register_in(_NETWORK_REGISTRY, "network model", name, factory, overwrite)


def list_network_models() -> tuple[str, ...]:
    return tuple(sorted(_NETWORK_REGISTRY))


def make_network_model(name: str, **kwargs) -> NetworkModel:
    """Build a network model by registry name; kwargs reach the factory."""
    return make_from(_NETWORK_REGISTRY, "network model", list_network_models,
                     name, kwargs)


def register_energy_model(name: str, factory: Callable[..., EnergyModel],
                          *, overwrite: bool = False) -> None:
    """Register an energy-model factory under ``name`` (case-insensitive)."""
    register_in(_ENERGY_REGISTRY, "energy model", name, factory, overwrite)


def list_energy_models() -> tuple[str, ...]:
    return tuple(sorted(_ENERGY_REGISTRY))


def make_energy_model(name: str, **kwargs) -> EnergyModel:
    """Build an energy model by registry name; kwargs reach the factory."""
    return make_from(_ENERGY_REGISTRY, "energy model", list_energy_models,
                     name, kwargs)


def register_environment(name: str, factory: Callable[..., Environment],
                         *, overwrite: bool = False) -> None:
    """Register an environment factory under ``name`` (case-insensitive)."""
    register_in(_ENV_REGISTRY, "environment", name, factory, overwrite)


def list_environments() -> tuple[str, ...]:
    return tuple(sorted(_ENV_REGISTRY))


def make_environment(name: str, **kwargs) -> Environment:
    """Build an environment by registry name."""
    return make_from(_ENV_REGISTRY, "environment", list_environments,
                     name, kwargs)


def _no_kwargs(kind: str, build):
    def factory(**kwargs):
        if kwargs:
            raise TypeError(f"{kind} accepts no parameters, got "
                            f"{sorted(kwargs)}")
        return build()
    return factory


register_network_model(
    "reference", _no_kwargs("network model 'reference'",
                            ReferenceNetworkModel))
register_network_model("lossy-wan",
                       lambda **kw: LossyWanNetworkModel(**kw))
register_energy_model(
    "reference", _no_kwargs("energy model 'reference'",
                            ReferenceEnergyModel))
register_energy_model("big-little",
                      lambda **kw: BigLittleEnergyModel(**kw))
register_environment(
    "reference", _no_kwargs("environment 'reference'", Environment))
register_environment(
    "lossy-wan",
    lambda **kw: Environment(network=LossyWanNetworkModel(**kw)))
register_environment(
    "big-little",
    lambda **kw: Environment(energy=BigLittleEnergyModel(**kw)))
# dvfs: the first-principles energy model with the reference wire physics
# (DvfsNetworkModel).  Kwargs parameterize the energy half: tech= selects a
# DVFS_TECHS preset, everything else overrides DvfsEnergyModel fields.
register_network_model(
    "dvfs", _no_kwargs("network model 'dvfs'", DvfsNetworkModel))
register_energy_model("dvfs", DvfsEnergyModel.for_tech)
register_environment(
    "dvfs",
    lambda **kw: Environment(network=DvfsNetworkModel(),
                             energy=DvfsEnergyModel.for_tech(**kw)))


def _logfit_environment(**kwargs):
    # Lazy: repro_torch.workloads.logfit imports this module for
    # Environment, so the factory defers the reverse import to first use.
    from repro_torch.workloads.logfit import logfit_environment
    return logfit_environment(**kwargs)


register_environment("logfit", _logfit_environment)


def as_environment(obj=None) -> Environment:
    """Coerce any accepted environment spelling into an Environment.

    Accepts ``None`` (the reference environment), an :class:`Environment`,
    a registry name, a bare :class:`NetworkModel` (paired with the
    reference energy model), or a bare :class:`EnergyModel` (paired with
    the reference network model).
    """
    if obj is None:
        return REFERENCE_ENV
    if isinstance(obj, Environment):
        return obj
    if isinstance(obj, str):
        return make_environment(obj)
    if isinstance(obj, NetworkModel):
        return Environment(network=obj)
    if isinstance(obj, EnergyModel):
        return Environment(energy=obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as an "
                    f"Environment")
