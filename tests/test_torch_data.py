"""The port's input pipeline against the JAX package's: the shard sources
and untuned batches are numpy on both sides and must agree bit for bit;
the tuned fetcher runs the port's controller on CPU scalar tensors (the
port of tests/test_infra.py::test_tuned_fetcher_produces_and_tunes)."""
import time

import numpy as np
import pytest
import torch

from repro.data import MemmapSource as JMemmapSource
from repro.data import SyntheticSource as JSyntheticSource
from repro.data import batches as j_batches
from repro_torch.core.types import SLA, SLAPolicy
from repro_torch.data import (MemmapSource, SyntheticSource, TunedFetcher,
                              batches)


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
def test_synthetic_source_equals_jax(dist):
    for seed, idx in [(0, 0), (3, 5), (7, 123)]:
        a = SyntheticSource(1000, 512, seed=seed, dist=dist).read_shard(idx)
        b = JSyntheticSource(1000, 512, seed=seed, dist=dist).read_shard(idx)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert a.max() < 1000


def test_memmap_source_equals_jax(tmp_path):
    paths = []
    for i in range(2):
        p = tmp_path / f"s{i}.npy"
        np.save(p, np.arange(i * 100, i * 100 + 64, dtype=np.int32))
        paths.append(str(p))
    for idx in range(3):
        np.testing.assert_array_equal(MemmapSource(paths).read_shard(idx),
                                      JMemmapSource(paths).read_shard(idx))


def test_untuned_batches_equal_jax():
    """Eight batches that cross shard boundaries (4 x 33 tokens from
    1,000-token shards)."""
    it = batches(SyntheticSource(100, 1000), batch=4, seq=32, tuned=False)
    jit = j_batches(JSyntheticSource(100, 1000), batch=4, seq=32,
                    tuned=False)
    for _ in range(8):
        b, jb = next(it), next(jit)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_tuned_fetcher_produces_and_tunes():
    f = TunedFetcher(SyntheticSource(100, 65536),
                     SLA(policy=SLAPolicy.MAX_THROUGHPUT, timeout_s=0.05,
                         max_ch=8))
    it = batches(f.source, batch=2, seq=64, tuned=True, fetcher=f)
    for _ in range(20):
        assert tuple(next(it)["tokens"].shape) == (2, 64)
    deadline = time.monotonic() + 20.0
    while len(f.trajectory) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    stats = f.stats
    it.close()                         # stops the fetcher
    assert f._stop.is_set()
    assert stats.bytes_fetched > 0
    assert 1 <= stats.workers <= 8
    assert stats.energy_j > 0
    for _, workers, cores, freq_idx in f.trajectory:
        assert 1 <= workers <= 16 and cores >= 1 and freq_idx >= 0


def test_tuned_fetcher_joins_its_threads_on_close():
    """Closing the batches generator stops the fetcher and joins its
    control thread and every worker: a thread left inside torch when the
    interpreter exits aborts the process.  A second stop() returns."""
    f = TunedFetcher(SyntheticSource(100, 4096),
                     SLA(policy=SLAPolicy.MAX_THROUGHPUT, timeout_s=0.05,
                         max_ch=8), max_workers=4, depth=2)
    it = batches(f.source, batch=2, seq=64, tuned=True, fetcher=f)
    for _ in range(4):
        next(it)
    threads = list(f._workers) + [f._ctl]
    assert len(threads) == 5 and all(t.is_alive() for t in threads)
    deadline = time.monotonic() + 20.0
    while not f.trajectory and time.monotonic() < deadline:
        time.sleep(0.02)                # the control loop has ticked
    it.close()
    assert not any(t.is_alive() for t in threads)
    t0 = time.monotonic()
    f.stop()
    assert time.monotonic() - t0 < 0.5
