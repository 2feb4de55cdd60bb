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

    make_network_model("reference")
    make_energy_model("reference")
    make_environment("reference")

Only the ``reference`` physics — the paper's calibrated models
(``repro_torch.core`` ``network_model`` / ``energy_model``) — exists in the
port so far; it is also the only environment the CUDA tick kernel spells
out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.core import energy_model, network_model
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
register_energy_model(
    "reference", _no_kwargs("energy model 'reference'",
                            ReferenceEnergyModel))
register_environment(
    "reference", _no_kwargs("environment 'reference'", Environment))


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
