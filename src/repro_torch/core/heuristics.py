"""Algorithm 1 — heuristic-based parameter initialization.

Runs once per transfer, on the host, before the transfer starts.  Mirrors
the paper line-by-line:

    1:  datasets = partitionFiles()
    2-5: split files larger than BDP into BDP-sized chunks
    6:  ppLevel = ceil(BDP / avgFileSize)
    8:  tputChannel = avgWinSize / RTT
    9:  numChannels = ceil(bandwidth / tputChannel)
    10-13: ccLevel_i = ceil(weight_i * numChannels),  weight_i ∝ partition bytes
    14-20: SLA -> (numActiveCores, coreFrequency)

The arithmetic is float32, as in the JAX package: a quotient of Python
floats is rounded to float32 *before* ``ceil`` (``np.ceil(np.float32(x))``,
not ``math.ceil``), and partition weights are float32 sums taken left to
right.  :func:`redistribute_channels` runs inside the tick loop, on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ._f32 import col, ftz, sum_lr
from .types import (CpuProfile, DatasetSpec, NetworkProfile, SLA, SLAPolicy,
                    TransferParams)


def _ceil32(x: float) -> float:
    return float(np.ceil(np.float32(x)))


def split_large_files(spec: DatasetSpec, bdp_mb: float) -> tuple[DatasetSpec, float]:
    """Lines 2-5: chunk files larger than the BDP; returns (spec', parallelism).

    Chunking is equivalent to per-file parallelism ``ceil(avgFile / BDP)``:
    each chunk rides its own sub-stream and exactly fills the channel.
    """
    if spec.avg_file_mb > bdp_mb and bdp_mb > 0:
        par = float(int(_ceil32(spec.avg_file_mb / bdp_mb)))
        chunk = spec.avg_file_mb / par
        spec = DatasetSpec(
            name=spec.name,
            num_files=int(spec.num_files * par),
            total_mb=spec.total_mb,
            avg_file_mb=chunk,
            std_file_mb=spec.std_file_mb / par,
        )
        return spec, par
    return spec, 1.0


def initialize(
    specs,
    profile: NetworkProfile,
    cpu: CpuProfile,
    sla: SLA,
) -> tuple[TransferParams, tuple[DatasetSpec, ...]]:
    """Full Algorithm 1. Returns (initial TransferParams, chunked specs);
    the parameters are host numpy (float32 arrays, int32 scalars)."""
    bdp = profile.bdp_mb

    chunked, par = [], []
    for s in specs:
        s2, p = split_large_files(s, bdp)
        chunked.append(s2)
        par.append(p)
    chunked = tuple(chunked)

    # line 6: pipelining amortizes per-file RTTs for small files.
    pp = [max(1.0, _ceil32(bdp / max(s.avg_file_mb, 1e-6))) for s in chunked]
    # Cap pipelining: beyond ~the per-channel queue there is no extra win.
    pp = [min(p_, 128.0) for p_ in pp]

    # lines 8-9: minimum channels that fill the pipe.  For the target-
    # throughput SLA the "pipe" to fill is the target, not the bandwidth.
    goal_mbps = profile.bandwidth_mbps
    if sla.policy == SLAPolicy.TARGET_THROUGHPUT and sla.target_tput_mbps > 0:
        goal_mbps = min(goal_mbps, sla.target_tput_mbps)
    tput_channel = profile.avg_window_mb / profile.rtt_s
    num_channels = _ceil32(goal_mbps / max(tput_channel, 1e-6))

    # lines 10-13: distribute channels by partition weight.
    sizes = np.asarray([s.total_mb for s in chunked], np.float32)
    total = np.float32(0.0)
    for s in sizes:
        total = total + s
    weights = sizes / np.maximum(total, np.float32(1e-6))
    cc = np.maximum(np.ceil(weights * np.float32(num_channels)),
                    np.float32(1.0))

    # lines 14-20: SLA-dependent CPU operating point.
    if sla.policy == SLAPolicy.MIN_ENERGY:
        cores, freq_idx = 1, 0
    else:  # throughput-oriented: all cores, min frequency (load control raises f)
        cores, freq_idx = cpu.num_cores, 0

    params = TransferParams(
        pp=np.asarray(pp, np.float32),
        par=np.asarray(par, np.float32),
        cc=cc.astype(np.float32),
        cores=np.int32(cores),
        freq_idx=np.int32(freq_idx),
    )
    return params, chunked


def redistribute_channels(num_ch, remaining_mb):
    """Lines 10-13 of Alg 1 / the ``updateWeights`` loop of Algs 2,4,5,6.

    Weights follow *remaining* bytes so slower partitions get more channels
    and all partitions finish together (paper §IV-A, last paragraph).
    ``num_ch`` is ``[B]``, ``remaining_mb`` ``[B, P]``.
    """
    remaining = remaining_mb.clamp_min(0.0)
    w = ftz(remaining / col(sum_lr(remaining).clamp_min(1e-6)))
    # Fluid (continuous) channel allocation: a cc of 0.5 models a channel
    # duty-cycled at 50% — what keeps ΣccLevel_i == numCh exactly.
    active = (remaining > 0.0).to(torch.float32)
    return ftz(w * col(num_ch)) * active
