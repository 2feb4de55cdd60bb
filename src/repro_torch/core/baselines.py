"""Baseline transfer controllers the paper compares against (§V).

All baselines share the engine/controller interface so the comparison is
apples-to-apples on the same substrate:

  * ``single_stream``   — wget / curl: 1 channel, no pipelining, no
                          parallelism, all cores at max frequency (OS default
                          "performance" governor), zero runtime tuning.
  * ``multiplexed``     — http/2: one TCP connection with request
                          multiplexing == deep pipelining on a single channel.
  * ``ismail_min_energy``, ``ismail_max_tput`` — the static heuristic tuners
    of Alan/Ismail et al.: one-shot parameter choice from dataset statistics,
    NO runtime adaptation, NO frequency/core scaling.  Their documented
    pathology is reproduced: parallelism = floor(avgFile / buffer), which
    collapses to 1 as the buffer grows to the BDP (paper §V-A).

Parameters are host numpy: they are fixed before the transfer starts.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .types import CpuProfile, NetworkProfile, TransferParams


@dataclasses.dataclass(frozen=True)
class StaticController:
    """A controller that never changes its parameters at runtime."""

    name: str
    params: TransferParams

    # Engine hooks — static controllers ignore feedback entirely.
    tunes: bool = False
    scaling: bool = False


def _mk(name, pp, par, cc, cores, freq_idx) -> StaticController:
    p = TransferParams(
        pp=np.asarray(pp, np.float32),
        par=np.asarray(par, np.float32),
        cc=np.asarray(cc, np.float32),
        cores=np.int32(cores),
        freq_idx=np.int32(freq_idx),
    )
    return StaticController(name=name, params=p)


def single_stream(specs, cpu: CpuProfile) -> StaticController:
    """wget/curl: sequential, one connection, one partition at a time."""
    n = len(specs)
    # One channel total: give it to every partition but the engine's
    # active-mask drains them; cc=1 each approximates serial single-stream.
    return _mk("wget/curl", [1.0] * n, [1.0] * n, [1.0] * n,
               cpu.num_cores, len(cpu.freq_levels_ghz) - 1)


def multiplexed(specs, cpu: CpuProfile) -> StaticController:
    """http/2: single connection, deep multiplexing (pipelining)."""
    n = len(specs)
    return _mk("http/2", [64.0] * n, [1.0] * n, [1.0] * n,
               cpu.num_cores, len(cpu.freq_levels_ghz) - 1)


def _ismail_params(specs, profile: NetworkProfile):
    """Alan/Ismail static heuristic.

    Their tuner sizes the socket buffer to the BDP, so parallelism
    ``floor(avgFile / buffer)`` collapses to 1 for any file smaller than the
    BDP — the pathology the paper calls out in §V-A.  No file chunking, no
    runtime adaptation, no channel redistribution.
    """
    pp, par, cc = [], [], []
    for s in specs:
        par.append(max(1.0, float(math.floor(s.avg_file_mb / profile.bdp_mb))))
        pp.append(max(1.0, min(float(math.ceil(profile.bdp_mb / max(s.avg_file_mb, 1e-6))), 32.0)))
        cc.append(max(1.0, min(float(s.num_files), 4.0)))
    return pp, par, cc


def ismail_min_energy(specs, profile: NetworkProfile, cpu: CpuProfile) -> StaticController:
    """Min-energy flavour: few channels — but CPU at OS defaults (they tune
    only app-level parameters; no frequency/core scaling)."""
    pp, par, cc = _ismail_params(specs, profile)
    cc = [max(1.0, c / 2.0) for c in cc]
    return _mk("ismail-min-energy", pp, par, cc,
               cpu.num_cores, len(cpu.freq_levels_ghz) - 1)


def ismail_max_tput(specs, profile: NetworkProfile, cpu: CpuProfile) -> StaticController:
    pp, par, cc = _ismail_params(specs, profile)
    return _mk("ismail-max-tput", pp, par, cc,
               cpu.num_cores, len(cpu.freq_levels_ghz) - 1)


BASELINE_BUILDERS = {
    "wget/curl": lambda specs, prof, cpu: single_stream(specs, cpu),
    "http/2": lambda specs, prof, cpu: multiplexed(specs, cpu),
    "ismail-min-energy": ismail_min_energy,
    "ismail-max-tput": ismail_max_tput,
}
