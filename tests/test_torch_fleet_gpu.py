"""The offline fleet on the card (``gpu`` marker; skipped without one): the
tick kernel's wave mode against the plain wave loop, bit for bit, and
tests/test_fleet.py's 16-transfer golden through ``run_fleet`` on the
card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_fleet_gpu.py
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import api, fleet
from repro_torch.core.types import CHAMELEON
from repro_torch.fleet.admission import Combo
from repro_torch.kernels import tick_loop as tl

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  (the fleet goldens and their traces)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env", [None, "lossy-wan", "big-little", "dvfs"])
@pytest.mark.parametrize("step0", [(0, 0, 0), (0, 3, 5)])
def test_wave_mode_equals_plain_wave(cuda_device, env, step0):
    """Every controller kind's batch of three lanes (shares 1.0 / 0.7 /
    0.45) under ``env``, all groups in one launch a wave, for 8 waves of 7
    ticks (controller stride 2): rows and done_at bit-equal to the plain
    wave on the card."""
    fast, one = chip_smoke.fleet_small_datasets()
    learned = api.make_controller("learned",
                                  params=chip_smoke.golden_learned()[0])
    ctrls = ["eemt", "me", api.make_controller("eett",
                                               target_tput_mbps=400.0),
             api.make_controller("ismail-target", target_tput_mbps=400.0),
             "wget/curl", learned]
    host = fleet.Host("h", environment=env)
    dev = cuda_device
    bw = torch.tensor([1.0, 0.7, 0.45], device=dev)
    groups = []
    for c in ctrls:
        combos = [Combo(fleet.TransferRequest(0.0, ds, c, CHAMELEON), host,
                        0.5) for ds in (fast, one, fast)]
        for cb in combos:
            cb.finalize(2)
        rows = [torch.as_tensor(np.stack([getattr(cb, f) for cb in combos]),
                                device=dev)
                for f in ("params_row", "f0", "i0")]
        groups.append((combos[0].key, rows[0], (rows[1], rows[2]),
                       (rows[1], rows[2])))
    for w in range(8):
        s0 = torch.tensor(step0, dtype=torch.int32, device=dev) + 7 * w
        waves = [tl.Wave(code, env_code, cpu, prow, bw, *kern, s0, 7, 0.5,
                         ce)
                 for (code, env_code, cpu, ce), prow, kern, _ in groups]
        before = tl.tick_loop.launches
        outs = tl.tick_wave_grouped(waves)
        assert tl.tick_loop.launches - before == 1
        nxt = []
        for (key, prow, _, plain), wv, out in zip(groups, waves, outs):
            want = tl.tick_wave_reference(
                wv.controller, wv.env, wv.cpu, prow, bw, *plain, s0,
                wave_steps=7, dt=0.5, ctrl_every=wv.ctrl_every)
            for a, b in zip(out, want):
                assert torch.equal(a, b), (key, w)
            nxt.append((key, prow, out[:2], want[:2]))
        groups = nxt


@pytest.mark.gpu
def test_fleet_golden_on_the_card(cuda_device):
    hosts = fleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    rep = fleet.run_fleet(chip_smoke.fleet16_trace(), hosts, wave_s=10.0,
                          dt=0.5, devices=[cuda_device])
    got = {t.name: (t.energy_j, t.time_s, t.start_s, t.host, t.completed)
           for t in rep.transfers}
    assert got == chip_smoke.FLEET16_GOLDEN
    assert rep.total_energy_j == math.fsum(
        v[0] for v in chip_smoke.FLEET16_GOLDEN.values())
    assert (rep.sim_s, rep.waves) == (130.0, 12)
    plain = fleet.run_fleet(chip_smoke.fleet16_trace(), hosts, wave_s=10.0,
                            dt=0.5, devices=[cuda_device],
                            executor="reference")
    assert [chip_smoke.fleet_fields(t) for t in rep.transfers] == \
        [chip_smoke.fleet_fields(t) for t in plain.transfers]
