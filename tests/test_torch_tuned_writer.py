"""repro_torch.ckpt.TunedCheckpointWriter against the JAX package's writer.

* tests/test_infra.py::test_tuned_checkpoint_writer_roundtrip on the port,
  with every shard equal to the JAX writer's on the same state (leaves in
  ``jax.tree`` order, bfloat16 stored as uint16);
* the EETT tick: the writer count the port's controller picks over a
  throughput sequence equals what the JAX package's ``tuners.update``
  picks for it, with the tuner state equal at every tick;
* no writer thread is alive after ``write`` returns or raises.
"""
import glob
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import TunedCheckpointWriter as JWriter
from repro.core import tuners as jtuners
from repro_torch.ckpt import TunedCheckpointWriter


def _state(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    e = rng.standard_normal((3, 40)).astype(np.float32)
    jstate = {"w": jnp.asarray(w), "b": jnp.asarray(b),
              "layers": [{"e": jnp.asarray(e, jnp.bfloat16)},
                         {"e": jnp.asarray(e[::-1], jnp.bfloat16)}]}
    tstate = {"w": torch.from_numpy(w), "b": torch.from_numpy(b),
              "layers": [{"e": torch.from_numpy(e).to(torch.bfloat16)},
                         {"e": torch.from_numpy(e[::-1].copy())
                          .to(torch.bfloat16)}]}
    return jstate, tstate


def _shards(d):
    paths = sorted(glob.glob(os.path.join(d, "shard_*.npy")))
    return {os.path.basename(p): np.load(p) for p in paths}


def test_roundtrip_and_shards_equal_jax(tmp_path):
    """tests/test_infra.py's round trip, then a tree with a list and
    bfloat16 leaves: the port's shards equal the JAX writer's file for
    file, dtype for dtype."""
    state = {"w": np.random.randn(128, 128).astype(np.float32),
             "b": np.random.randn(64).astype(np.float32)}
    d = str(tmp_path / "np")
    stats = TunedCheckpointWriter(target_mbps=100.0, max_writers=2,
                                  timeout_s=0.05).write(d, state)
    assert stats["bytes"] == sum(a.nbytes for a in state.values())
    back = _shards(d)
    assert sorted(back) == ["shard_0.npy", "shard_1.npy"]
    np.testing.assert_array_equal(back["shard_0.npy"], state["b"])
    np.testing.assert_array_equal(back["shard_1.npy"], state["w"])

    jstate, tstate = _state()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    JWriter(target_mbps=100.0, max_writers=2, timeout_s=0.05).write(jd,
                                                                    jstate)
    stats = TunedCheckpointWriter(target_mbps=100.0, max_writers=2,
                                  timeout_s=0.05).write(td, tstate)
    want, got = _shards(jd), _shards(td)
    assert sorted(got) == sorted(want) and len(got) == 4
    for name, a in want.items():
        assert got[name].dtype == a.dtype and got[name].dtype != np.float16
        np.testing.assert_array_equal(got[name], a)
    assert got["shard_1.npy"].dtype == np.uint16
    assert stats["bytes"] == sum(a.nbytes for a in want.values())


def test_writer_count_follows_jax_tuner():
    """The EETT tick over a throughput sequence (ramp, overshoot, sag):
    the port's tuner state and writer count equal JAX's at every tick."""
    tw = TunedCheckpointWriter(target_mbps=150.0, max_writers=8,
                               timeout_s=0.25)
    jw = JWriter(target_mbps=150.0, max_writers=8, timeout_s=0.25)
    ts = jw._ts
    seq = [40.0, 150.0, 300.0, 300.0, 300.0, 300.0, 300.0, 300.0, 50.0,
           50.0, 50.0, 50.0, 150.0, 150.0, 160.0, 140.0, 0.0, 20.0, 45.5,
           80.0, 130.0, 155.0, 210.0, 700.0, 149.9, 151.0]
    counts, jcounts = [], []
    for tput in seq:
        counts.append(tw.tick(tput))
        meas = jtuners.Measurement(
            avg_tput=jnp.float32(tput), energy_j=jnp.float32(1.0),
            avg_power=jnp.float32(1.0), remaining_mb=jnp.float32(1e6),
            cpu_load=jnp.float32(min(tput / 500.0, 1.0)),
            interval_s=jnp.float32(jw.sla.timeout_s))
        ts = jtuners.update(ts, meas, jw.profile, jw.cpu, jw.sla,
                            scaling=False)
        jcounts.append(int(np.clip(round(float(ts.num_ch)), 1,
                                   jw.max_writers)))
        for got, want in zip(tw._ts, ts):
            assert float(got) == float(want), (tput, tw._ts, ts)
    assert counts == jcounts
    assert {1, 2, 3, 4} <= set(counts)   # the controller moved


def _writer_threads():
    return [t for t in threading.enumerate()
            if getattr(t, "_target", None) is not None
            and getattr(t._target, "__qualname__", "").startswith(
                "TunedCheckpointWriter.write")]


def test_no_thread_outlives_write(tmp_path, monkeypatch):
    """Every writer thread is joined when ``write`` returns, when the
    controller tick raises, and when a writer's save raises (that error
    reaches the caller)."""
    _, tstate = _state(1)
    w = TunedCheckpointWriter(target_mbps=50.0, max_writers=4,
                              timeout_s=0.01)
    w.write(str(tmp_path / "ok"), tstate)
    assert not _writer_threads()

    def bad_tick(tput):
        raise RuntimeError("tick failed")

    big = {"x": [np.zeros(1 << 20, np.float32) for _ in range(16)]}
    w = TunedCheckpointWriter(max_writers=4, timeout_s=0.001)
    monkeypatch.setattr(w, "tick", bad_tick)
    with pytest.raises(RuntimeError, match="tick failed"):
        w.write(str(tmp_path / "tick"), big)
    assert not _writer_threads()

    def bad_save(path, a):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", bad_save)
    w = TunedCheckpointWriter(max_writers=4, timeout_s=0.01)
    with pytest.raises(OSError, match="disk full"):
        w.write(str(tmp_path / "save"), tstate)
    assert not _writer_threads()
