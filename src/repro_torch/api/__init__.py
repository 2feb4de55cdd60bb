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
``sweep`` with a per-cell cache, and returns a columnar :class:`Report`.
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

__all__ = [
    "Axis", "BigLittleEnergyModel", "Cell", "Controller", "ControllerInit",
    "DvfsEnergyModel", "DvfsNetworkModel", "EnergyModel", "Environment",
    "Experiment", "GroupRun", "IsmailTargetController",
    "LossyWanNetworkModel", "NetworkModel", "ReferenceEnergyModel",
    "ReferenceNetworkModel", "Report", "Scenario",
    "StaticBaselineController", "TransferResult", "TunerController",
    "as_controller", "as_environment", "axis", "chain", "clear_cache",
    "fingerprint", "grid", "group_count", "list_controllers",
    "list_energy_models", "list_environments", "list_network_models",
    "make_controller", "make_energy_model", "make_environment",
    "make_network_model", "register_controller", "register_energy_model",
    "register_environment", "register_network_model", "resolve_device",
    "run", "run_groups", "scenario_key", "sweep", "zip_",
]
