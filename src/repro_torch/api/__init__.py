"""repro_torch.api — the public surface of the PyTorch port.

One engine substrate, many controllers, compared apples-to-apples:

    >>> from repro_torch import api
    >>> from repro_torch.core.types import CHAMELEON, MIXED
    >>> sc = api.Scenario(profile=CHAMELEON, datasets=MIXED,
    ...                   controller="eemt", total_s=1800.0)
    >>> result = api.run(sc)                  # on the CUDA device
    >>> result = api.run(sc, device="cpu")    # plain PyTorch on the CPU

Controllers are addressed by registry name (``api.list_controllers()``) or
constructed directly; the physics they run against is an
:class:`Environment` (``api.list_environments()``: ``reference``,
``lossy-wan``, ``big-little``, ``dvfs``, ``logfit``), which pairs a
:class:`NetworkModel` with an :class:`EnergyModel`.  ``api.sweep([...])``
groups shape-compatible scenarios — same controller code AND environment
code — and runs each group as one lane batch: one launch of the CUDA tick
kernel on a card.  An :class:`Experiment` declares a whole grid of
scenarios (``axis`` / ``grid`` / ``zip_`` / ``chain``), runs it through
``sweep`` with a per-cell cache, and returns a columnar :class:`Report`;
``tune`` searches one (successive halving over common-random-number
bandwidth schedules, then grid refinement).  ``run_fleet`` drives an
arrival trace over a host pool (``repro_torch.fleet``).
"""
from repro_torch.core.engine import TransferResult  # noqa: F401

from .controllers import (Controller, ControllerInit,  # noqa: F401
                          IsmailTargetController, StaticBaselineController,
                          TunerController, as_controller, list_controllers,
                          make_controller, register_controller)
from .environments import (BigLittleEnergyModel,  # noqa: F401
                           DvfsEnergyModel, DvfsNetworkModel, EnergyModel,
                           Environment, LossyWanNetworkModel, NetworkModel,
                           ReferenceEnergyModel, ReferenceNetworkModel,
                           as_environment, list_energy_models,
                           list_environments, list_network_models,
                           make_energy_model, make_environment,
                           make_network_model, register_energy_model,
                           register_environment, register_network_model)
from .experiments import (Axis, Cell, Experiment, axis, chain,  # noqa: F401
                          clear_cache, fingerprint, grid, scenario_key,
                          zip_)
from .report import Report  # noqa: F401
from .scenario import (GroupRun, Scenario, group_count,  # noqa: F401
                       resolve_device, run, run_groups, sweep)
from .tuning import TuneResult, crn_bw_schedule, tune  # noqa: F401

# Fleet-scale entry points.  repro_torch.fleet builds ON TOP of the
# Scenario / engine substrate and the controller registry above, so these
# re-exports resolve lazily (PEP 562) — importing repro_torch.fleet first
# must not recurse back into a half-initialized repro_torch.api.
_FLEET_EXPORTS = ("FleetReport", "Host", "OnlineConfig",
                  "OnlineFleetReport", "TransferRequest", "diurnal_stream",
                  "host_pool", "poisson_stream", "poisson_trace",
                  "replay_stream", "replay_trace", "run_fleet",
                  "run_fleet_online")


def __getattr__(name):
    if name in _FLEET_EXPORTS:
        from repro_torch import fleet
        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Axis", "BigLittleEnergyModel", "Cell", "Controller", "ControllerInit",
    "DvfsEnergyModel", "DvfsNetworkModel", "EnergyModel", "Environment",
    "Experiment", "FleetReport", "GroupRun", "Host",
    "IsmailTargetController", "LossyWanNetworkModel", "NetworkModel",
    "OnlineConfig", "OnlineFleetReport",
    "ReferenceEnergyModel", "ReferenceNetworkModel", "Report", "Scenario",
    "StaticBaselineController", "TransferRequest", "TransferResult",
    "TuneResult", "TunerController", "as_controller", "as_environment",
    "axis", "chain", "clear_cache", "crn_bw_schedule", "diurnal_stream",
    "fingerprint", "grid", "group_count", "host_pool", "list_controllers",
    "list_energy_models", "list_environments", "list_network_models",
    "make_controller", "make_energy_model", "make_environment",
    "make_network_model", "poisson_stream", "poisson_trace",
    "register_controller", "register_energy_model",
    "register_environment", "register_network_model", "replay_stream",
    "replay_trace", "resolve_device", "run", "run_fleet",
    "run_fleet_online", "run_groups",
    "scenario_key", "sweep", "tune", "zip_",
]
