"""The Controller protocol and its implementations (PyTorch).

A controller owns *all* of its transfer semantics:

  * ``init``     — host-side, once per scenario: initial parameters, initial
                   tuner state, (possibly chunked) dataset specs, numeric SLA
                   view, and the static channel weights it wants threaded
                   through the tick loop (numpy).
  * ``tick``     — one controller interval over a lane batch of tensors
                   (Algorithms 2-6 for the paper tuners; identity for static
                   baselines).
  * ``channels`` — the per-tick channel allocation across partitions
                   (remaining-bytes redistribution for adaptive controllers,
                   frozen original weights for Ismail's target tuner).

Instances are frozen, hashable config objects; every numeric quantity flows
through ``init``'s return value.  ``code()`` returns a numerics-stripped
canonical instance — scenarios whose controllers have equal ``code()`` run
as one lane batch in :func:`repro_torch.api.sweep`.

The string registry::

    make_controller("eemt", max_ch=64)
    make_controller("eett", target_tput_mbps=500.0)
    make_controller("wget/curl")
    make_controller("learned", params=...)   # repro_torch.learn
    list_controllers()
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import baselines, heuristics, tuners
from repro_torch.core._f32 import col, ftz
from repro_torch.core.types import (CpuProfile, NetworkProfile, SLA,
                                    SLAParams, SLAPolicy, SimState,
                                    TransferParams, TunerState)

from ._registry import make_from, register_in


class ControllerInit(NamedTuple):
    """Host-side output of ``Controller.init``.

    ``static_weights`` is [P] float32 — zeros when the controller
    redistributes channels by remaining bytes instead.
    """

    params: TransferParams
    state: TunerState
    specs: tuple                 # possibly chunked DatasetSpecs
    sla: SLAParams               # numeric SLA view
    static_weights: np.ndarray


@runtime_checkable
class Controller(Protocol):
    """Anything the engine can run.  See the module docstring."""

    name: str
    tunes: bool        # False -> tick is never invoked (static baselines)
    timeout_s: float   # controller-tick interval (ignored when not tunes)

    def code(self) -> "Controller":
        """Numerics-stripped canonical instance (the lane-batch group key)."""
        ...

    def init(self, specs, profile: NetworkProfile,
             cpu: CpuProfile) -> ControllerInit:
        ...

    def tick(self, state: TunerState, meas: "tuners.Measurement", net,
             cpu: CpuProfile, sla: SLAParams) -> TunerState:
        ...

    def channels(self, state: TunerState, sim: SimState,
                 static_w) -> torch.Tensor:
        ...


def _os_default(cpu: CpuProfile) -> tuple[int, int]:
    """Performance governor: all cores awake, maximum frequency."""
    return cpu.num_cores, len(cpu.freq_levels_ghz) - 1


_POLICY_NAMES = {SLAPolicy.MIN_ENERGY: "ME",
                 SLAPolicy.MAX_THROUGHPUT: "EEMT",
                 SLAPolicy.TARGET_THROUGHPUT: "EETT"}


@dataclasses.dataclass(frozen=True)
class TunerController:
    """The paper's SLA tuners (ME / EEMT / EETT) + Algorithm-3 load control."""

    sla: SLA = SLA()
    scaling: bool = True
    label: Optional[str] = None

    tunes = True

    @property
    def name(self) -> str:
        if self.label:
            return self.label
        base = _POLICY_NAMES[self.sla.policy]
        return base if self.scaling else base + "-noscale"

    @property
    def timeout_s(self) -> float:
        return self.sla.timeout_s

    def code(self) -> "TunerController":
        # tick() reads only policy + scaling from self; everything numeric
        # arrives via SLAParams, so defaults are equivalent here.
        return TunerController(sla=SLA(policy=self.sla.policy),
                               scaling=self.scaling)

    def init(self, specs, profile, cpu) -> ControllerInit:
        params, chunked = heuristics.initialize(specs, profile, cpu, self.sla)
        num_ch0 = float(np.sum(np.asarray(params.cc)))
        if self.scaling:
            cores0, freq0 = int(params.cores), int(params.freq_idx)
        else:
            # Fig. 4 ablation: load control removed -> host runs OS defaults.
            cores0, freq0 = _os_default(cpu)
        state = tuners.init_tuner_state(num_ch0, cores0, freq0)
        return ControllerInit(params, state, chunked,
                              SLAParams.from_sla(self.sla),
                              np.zeros(len(chunked), np.float32))

    def tick(self, state, meas, net, cpu, sla):
        return tuners.update(state, meas, net, cpu, sla,
                             scaling=self.scaling, policy=self.sla.policy)

    def channels(self, state, sim, static_w):
        return heuristics.redistribute_channels(state.num_ch,
                                                sim.remaining_mb)


@dataclasses.dataclass(frozen=True)
class IsmailTargetController:
    """Ismail et al. target tuner (paper §V-B): 1-channel start, ±1 channel
    per timeout, channels split by the ORIGINAL partition weights (never
    rebalanced by remaining bytes), no frequency/core scaling."""

    sla: SLA = SLA(policy=SLAPolicy.ISMAIL_TARGET)
    label: Optional[str] = None

    tunes = True

    def __post_init__(self):
        if self.sla.policy != SLAPolicy.ISMAIL_TARGET:
            object.__setattr__(
                self, "sla",
                dataclasses.replace(self.sla,
                                    policy=SLAPolicy.ISMAIL_TARGET))

    @property
    def name(self) -> str:
        return self.label or "ismail-target"

    @property
    def timeout_s(self) -> float:
        return self.sla.timeout_s

    def code(self) -> "IsmailTargetController":
        return IsmailTargetController()

    def init(self, specs, profile, cpu) -> ControllerInit:
        params, chunked = heuristics.initialize(specs, profile, cpu, self.sla)
        cores0, freq0 = _os_default(cpu)
        state = tuners.init_tuner_state(1.0, cores0, freq0)
        totals = np.array([s.total_mb for s in chunked], np.float32)
        return ControllerInit(params, state, chunked,
                              SLAParams.from_sla(self.sla),
                              totals / totals.sum())

    def tick(self, state, meas, net, cpu, sla):
        return tuners.update(state, meas, net, cpu, sla, scaling=False,
                             policy=SLAPolicy.ISMAIL_TARGET)

    def channels(self, state, sim, static_w):
        active = (sim.remaining_mb > 0.0).to(torch.float32)
        return ftz(static_w * col(state.num_ch)) * active


def _freeze_params(params: TransferParams) -> tuple:
    return (tuple(float(x) for x in np.asarray(params.pp)),
            tuple(float(x) for x in np.asarray(params.par)),
            tuple(float(x) for x in np.asarray(params.cc)),
            int(params.cores), int(params.freq_idx))


@dataclasses.dataclass(frozen=True)
class StaticBaselineController:
    """A controller that never changes its parameters at runtime (wget/curl,
    http/2, the Alan/Ismail static heuristic tuners).

    Either ``builder`` names an entry in ``baselines.BASELINE_BUILDERS``
    (parameters derived from dataset statistics at init time), or ``params``
    carries explicit frozen parameters.
    """

    label: str
    builder: Optional[str] = None
    params: Optional[tuple] = None   # (pp, par, cc, cores, freq_idx) tuples

    tunes = False
    timeout_s = 1.0                  # never consulted: tunes is False

    @property
    def name(self) -> str:
        return self.label

    def code(self) -> "StaticBaselineController":
        # All static baselines share one tick loop: differences are numeric.
        return StaticBaselineController(label="<static>")

    def init(self, specs, profile, cpu) -> ControllerInit:
        if self.params is not None:
            pp, par, cc, cores, freq_idx = self.params
        else:
            built = baselines.BASELINE_BUILDERS[self.builder](
                tuple(specs), profile, cpu)
            pp, par, cc, cores, freq_idx = _freeze_params(built.params)
        params = TransferParams(
            pp=np.asarray(pp, np.float32),
            par=np.asarray(par, np.float32),
            cc=np.asarray(cc, np.float32),
            cores=np.int32(cores),
            freq_idx=np.int32(freq_idx),
        )
        state = tuners.init_tuner_state(float(sum(cc)), cores, freq_idx)
        return ControllerInit(params, state, tuple(specs),
                              SLAParams.from_sla(SLA()),
                              np.zeros(len(tuple(specs)), np.float32))

    def tick(self, state, meas, net, cpu, sla):
        return state

    def channels(self, state, sim, static_w):
        return heuristics.redistribute_channels(state.num_ch,
                                                sim.remaining_mb)


# --------------------------------------------------------------- registry --

_REGISTRY: dict[str, Callable[..., Controller]] = {}


def register_controller(name: str, factory: Callable[..., Controller],
                        *, overwrite: bool = False) -> None:
    """Register a controller factory under ``name`` (case-insensitive)."""
    register_in(_REGISTRY, "controller", name, factory, overwrite)


def list_controllers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_controller(name: str, **kwargs) -> Controller:
    """Build a controller by registry name.

    Tuner names accept SLA hyper-parameter overrides as keyword arguments
    (``alpha``, ``beta``, ``delta_ch``, ``max_ch``, ``timeout_s``,
    ``target_tput_mbps``, ...) plus ``scaling=`` and ``label=``.
    """
    return make_from(_REGISTRY, "controller", list_controllers, name, kwargs)


def _tuner_factory(policy: SLAPolicy):
    def factory(sla: Optional[SLA] = None, *, scaling: Optional[bool] = None,
                label: Optional[str] = None, **sla_kwargs) -> Controller:
        if sla is None:
            sla = SLA(policy=policy, **sla_kwargs)
        elif sla_kwargs:
            sla = dataclasses.replace(sla, **sla_kwargs)
        sla = dataclasses.replace(sla, policy=policy)
        if policy == SLAPolicy.ISMAIL_TARGET:
            if scaling is not None:
                # The baseline has no load-control module at all — reject
                # rather than silently running a wrong ablation.
                raise TypeError("ismail-target never scales frequency/cores; "
                                "the scaling kwarg does not apply")
            return IsmailTargetController(sla=sla, label=label)
        return TunerController(sla=sla,
                               scaling=True if scaling is None
                               else bool(scaling),
                               label=label)
    return factory


def _static_factory(name: str):
    def factory(*, label: Optional[str] = None, **kwargs) -> Controller:
        if kwargs:
            raise TypeError(f"controller {name!r} accepts no "
                            f"hyper-parameters, got {sorted(kwargs)}")
        return StaticBaselineController(label=label or name, builder=name)
    return factory


def _learned_factory(*, params=None, cfg=None, sla: Optional[SLA] = None,
                     label: Optional[str] = None, **sla_kwargs) -> Controller:
    """``make_controller("learned", params=...)``.

    ``params`` is a trained policy dict (numpy arrays or tensors), a
    checkpoint directory written by ``save_policy`` of either package, or
    ``None`` (deterministic seed-0 init — enough for registry round-trips
    and smoke tests).  SLA keyword overrides (``timeout_s``, ``delta_ch``,
    ``max_ch``, ``policy``, ...) configure the starting operating point and
    the action scaling.  The learn stack imports lazily: the registry stays
    cheap for everyone who never asks for a learned controller.
    """
    import os

    from repro_torch.learn.controller import LearnedController, load_policy
    if sla is None:
        sla = SLA(**sla_kwargs) if sla_kwargs else SLA()
    elif sla_kwargs:
        sla = dataclasses.replace(sla, **sla_kwargs)
    if isinstance(params, (str, os.PathLike)):
        params = load_policy(str(params))
    return LearnedController(params=params, cfg=cfg, sla=sla, label=label)


for _policy in (SLAPolicy.MIN_ENERGY, SLAPolicy.MAX_THROUGHPUT,
                SLAPolicy.TARGET_THROUGHPUT):
    register_controller(_POLICY_NAMES[_policy], _tuner_factory(_policy))
register_controller("ismail-target",
                    _tuner_factory(SLAPolicy.ISMAIL_TARGET))
for _base in baselines.BASELINE_BUILDERS:
    register_controller(_base, _static_factory(_base))
register_controller("learned", _learned_factory)


def as_controller(obj, *, scaling: bool = True) -> Controller:
    """Coerce any accepted controller spelling into a Controller.

    Accepts a Controller, a registry name, an :class:`SLA` (run the matching
    paper tuner), or a ``baselines.StaticController``.  ``scaling=False``
    (the Fig. 4 ablation) applies to paper-tuner spellings and raises for
    controllers that have no load-control module.
    """
    if isinstance(obj, str):
        return make_controller(obj) if scaling else \
            make_controller(obj, scaling=False)
    if isinstance(obj, SLA):
        if obj.policy == SLAPolicy.ISMAIL_TARGET:
            return IsmailTargetController(sla=obj)
        return TunerController(sla=obj, scaling=scaling)
    if isinstance(obj, baselines.StaticController):
        return StaticBaselineController(label=obj.name,
                                        params=_freeze_params(obj.params))
    if isinstance(obj, Controller):
        if not scaling:
            if isinstance(obj, TunerController):
                return dataclasses.replace(obj, scaling=False)
            raise TypeError(f"{type(obj).__name__} has no load-control "
                            f"module; the scaling flag does not apply")
        return obj
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Controller")
