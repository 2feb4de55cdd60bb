"""The port's TickLayout has the JAX package's slot offsets, and its
pack/unpack reproduce ``repro.core.tickstate`` bit for bit."""
import types

import numpy as np
import pytest
import torch

from repro.core import tickstate as jts
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import tickstate as tts


def _random_rows(rng, p, b=16):
    """A [b]-lane batch of random states and parameter rows (numpy)."""
    sim = jtypes.SimState(
        remaining_mb=rng.uniform(0, 1e4, (b, p)).astype(np.float32),
        window_mb=rng.uniform(0, 64, (b, p)).astype(np.float32),
        t=rng.uniform(0, 3600, b).astype(np.float32),
        energy_j=rng.uniform(0, 1e5, b).astype(np.float32),
        bytes_moved=rng.uniform(0, 1e6, b).astype(np.float32))
    ts = jtypes.TunerState(
        fsm=rng.integers(0, 4, b).astype(np.int32),
        num_ch=rng.uniform(1, 64, b).astype(np.float32),
        prev_num_ch=rng.uniform(1, 64, b).astype(np.float32),
        ref=rng.uniform(0, 1e3, b).astype(np.float32),
        cores=rng.integers(1, 9, b).astype(np.int32),
        freq_idx=rng.integers(0, 7, b).astype(np.int32),
        acc_mb=rng.uniform(0, 1e4, b).astype(np.float32),
        acc_j=rng.uniform(0, 1e4, b).astype(np.float32),
        acc_s=rng.uniform(0, 60, b).astype(np.float32))
    return sim, ts


@pytest.mark.parametrize("p", [1, 2, 5])
def test_layout_offsets_match_jax(p):
    a, b = jts.TickLayout(p), tts.TickLayout(p)
    for slot in jts.TickLayout.__slots__:
        assert getattr(a, slot) == getattr(b, slot), slot
    assert (tts.N_NET, tts.N_SLA) == (jts.N_NET, jts.N_SLA)


@pytest.mark.parametrize("p", [1, 2, 5])
def test_state_pack_unpack_bit_exact_vs_jax(p):
    rng = np.random.default_rng(11 * p)
    jlay, tlay = jts.TickLayout(p), tts.TickLayout(p)
    for _ in range(5):
        sim, ts = _random_rows(rng, p)
        want_f, want_i = (np.stack(r) for r in zip(*[
            jlay.pack_state(jtypes.SimState(*[x[k] for x in sim]),
                            jtypes.TunerState(*[x[k] for x in ts]), xp=np)
            for k in range(len(sim.t))]))
        f32, i32 = tlay.pack_state(convert.to_torch(sim), convert.to_torch(ts))
        assert f32.dtype == torch.float32 and i32.dtype == torch.int32
        np.testing.assert_array_equal(f32.numpy(), want_f)
        np.testing.assert_array_equal(i32.numpy(), want_i)
        sim2, ts2 = tlay.unpack_state(f32, i32)
        for x, y in zip((*sim, *ts), (*sim2, *ts2)):
            assert np.array_equal(x, convert.to_numpy(y))


@pytest.mark.parametrize("p", [1, 2, 5])
def test_params_unpack_repack_bit_exact_vs_jax(p):
    rng = np.random.default_rng(5 + p)
    row = rng.uniform(-10, 1e4, jts.TickLayout(p).params_size).astype(
        np.float32)
    want = jts.TickLayout(p).unpack_params(row)
    got = tts.TickLayout(p).unpack_params(torch.as_tensor(row))
    assert want.keys() == got.keys()
    for f in want:
        assert np.array_equal(np.asarray(want[f]),
                              np.asarray(convert.to_numpy(got[f]))), f
    repacked = tts.TickLayout(p).pack_params(types.SimpleNamespace(**got))
    np.testing.assert_array_equal(repacked.numpy(), row)


@pytest.mark.parametrize("controller", ["eemt", "ismail-target"])
def test_prepared_params_row_matches_jax(controller):
    """The packed parameter row of a prepared scenario (MIXED: 3
    partitions) equals the JAX package's, given the same numpy inputs."""
    from repro import api as japi
    from repro.api import scenario as jscenario

    sc = japi.Scenario(profile=jtypes.CHAMELEON, datasets=jtypes.MIXED,
                       controller=controller, total_s=10.0)
    inputs = jscenario._prepare(sc).inputs
    lay = jts.TickLayout(3)
    want = lay.pack_params(inputs, xp=np)
    got = tts.TickLayout(3).pack_params(convert.to_torch(inputs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_layout_validates_and_hashes():
    with pytest.raises(ValueError):
        tts.TickLayout(0)
    assert tts.TickLayout(3) == tts.TickLayout(3)
    assert hash(tts.TickLayout(3)) == hash(tts.TickLayout(3))
    assert tts.TickLayout(3) != tts.TickLayout(4)
