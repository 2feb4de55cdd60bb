"""The online fleet on the card (``gpu`` marker; skipped without one): every
occupied slot pool of a wave in one launch of the tick kernel's wave
mode, against the plain wave loop bit for bit, and against the port's
offline ``run_fleet`` on the card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_fleet_online_gpu.py
"""
import os
import sys

import pytest
import torch

from repro_torch import fleet
from repro_torch.core.types import CHAMELEON
from repro_torch.kernels import tick_loop as tl

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  (the traces and the pair check)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _trace():
    fast, one = chip_smoke.fleet_small_datasets()
    return fleet.poisson_trace(rate_per_s=0.5, n_transfers=24,
                               datasets=[one, fast],
                               controllers=("eemt", "me", "wget/curl"),
                               profile=CHAMELEON, seed=11, total_s=600.0)


@pytest.mark.gpu
@pytest.mark.parametrize("wave_s,capacity", [(10.0, 64), (7.5, 8),
                                             (7.5, 1)])
def test_online_kernel_equals_plain_one_launch_a_wave(cuda_device, wave_s,
                                                      capacity):
    """The shared trace (2 hosts x 4 slots, dt 0.5) at an aligned and an
    unaligned wave (15 ticks over controller strides of 2), with pools of
    64, 8 and 1 slots: kernel == plain on every transfer and the summary,
    one launch a wave, and equal to the offline fleet on the card."""
    hosts = fleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    trace = _trace()
    on = chip_smoke.online_pair(trace, hosts, cuda_device, "online",
                                wave_s=wave_s, dt=0.5,
                                pool_capacity=capacity)
    assert on.fold.transfers == len(trace) == on.completed
    if capacity >= 8:       # admission never waits on a slot
        off = fleet.run_fleet(trace, hosts, wave_s=wave_s, dt=0.5,
                              devices=[cuda_device])
        assert [chip_smoke.fleet_fields(t) for t in on.transfers] == \
            [chip_smoke.fleet_fields(t) for t in off.transfers]
        assert (on.total_energy_j, on.sim_s, on.waves) == \
            (off.total_energy_j, off.sim_s, off.waves)


@pytest.mark.gpu
def test_above_eight_partitions_the_card_refuses(cuda_device):
    before = tl.tick_loop.launches
    with pytest.raises(ValueError, match="max_partitions"):
        fleet.run_fleet_online(_trace(), fleet.host_pool(2),
                               devices=[cuda_device], max_partitions=9)
    assert tl.tick_loop.launches == before
    rep = fleet.run_fleet_online(_trace()[:4], fleet.host_pool(2),
                                 devices=[cuda_device], max_partitions=9,
                                 executor="reference")
    assert rep.fold.transfers == 4 and tl.tick_loop.launches == before
