"""repro_torch.core — the paper's contribution in PyTorch: SLA-driven
energy-efficient transfer tuning with dynamic CPU frequency & core scaling.

    types         — SLA, profiles, datasets, state NamedTuples
    heuristics    — Algorithm 1 (initialization) + channel redistribution
    tuners        — Algorithms 4-6 (ME / EEMT / EETT) + Slow Start (Alg 2)
    load_control  — Algorithm 3 (threshold frequency/core scaling)
    energy_model  — RAPL-calibrated host power model
    dvfs          — first-principles DVFS host physics (V(f), CV²f, leakage)
    network_model — discrete-time WAN channel simulator
    tickstate     — flat state / parameter rows of a lane batch
    engine        — tick semantics and the reference / cuda executors
    baselines     — wget/curl, http/2, Alan/Ismail static tuners

The user-facing surface is ``repro_torch.api``.
"""
from . import (baselines, dvfs, energy_model, engine, fsm,  # noqa: F401
               heuristics, load_control, network_model, tickstate, tuners,
               types)
from .dvfs import DVFS_TECHS, DvfsEnergyModel  # noqa: F401
from .engine import TransferResult  # noqa: F401
from .types import (CHAMELEON, CLOUDLAB, DIDCLAB, LARGE_FILES,  # noqa: F401
                    MEDIUM_FILES, MIXED, SMALL_FILES, TESTBEDS, CpuProfile,
                    DatasetSpec, NetworkProfile, SLA, SLAPolicy,
                    TransferParams, TunerState)
