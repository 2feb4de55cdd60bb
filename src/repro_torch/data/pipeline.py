"""Input pipeline whose shard-fetch stage is governed by the paper's tuners
(the port of ``repro/data/pipeline.py``).

This is the paper's real (non-simulated) integration: the fetch stage has a
worker pool ("channels"), and every ``timeout_s`` the same ME / EEMT / EETT
controller that drives the simulator observes the measured bytes/s and
actuates (a) the worker count and (b) the host operating point of the
energy model (on a real host the actuation would write cpufreq and core
online flags; here it updates the accounted operating point -- the
controller logic is identical).  The controller runs
``repro_torch.core.energy_model`` and ``repro_torch.core.tuners.update`` on
0-d CPU tensors: it is host control logic, as in the JAX package.

Sources:
  * SyntheticSource -- deterministic numpy token shards (tests, examples)
  * MemmapSource    -- .npy token files on disk

:func:`batches` yields CPU int32 tensors; the trainer moves them to its
device.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..core import energy_model, tuners
from ..core.types import (CpuProfile, NetParams, NetworkProfile, SLA,
                          SLAParams, TunerState, host_tensors)


class SyntheticSource:
    """Infinite deterministic token shards (numpy, so the JAX package's
    source gives the same tokens).

    ``dist='zipf'`` (default) draws Zipf-distributed tokens so a model has
    unigram structure to learn; ``dist='uniform'`` draws uniform tokens.
    """

    def __init__(self, vocab_size: int, shard_tokens: int = 65536,
                 seed: int = 0, dist: str = "zipf"):
        self.vocab = vocab_size
        self.shard_tokens = shard_tokens
        self.seed = seed
        self.dist = dist

    def read_shard(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + idx)
        if self.dist == "uniform":
            return rng.integers(0, self.vocab, self.shard_tokens,
                                dtype=np.int32)
        z = rng.zipf(1.3, self.shard_tokens).astype(np.int64) - 1
        return (z % self.vocab).astype(np.int32)


class MemmapSource:
    """Token shards stored as .npy files."""

    def __init__(self, paths):
        self.paths = list(paths)

    def read_shard(self, idx: int) -> np.ndarray:
        return np.load(self.paths[idx % len(self.paths)], mmap_mode="r")[:]


@dataclasses.dataclass
class FetchStats:
    bytes_fetched: float = 0.0
    t_start: float = 0.0
    workers: int = 2
    cores: int = 1
    freq_idx: int = 0
    energy_j: float = 0.0


def _f32(x):
    return torch.tensor(np.float32(x))


class TunedFetcher:
    """Shard prefetcher with an SLA-tuned worker pool.

    The controller state machine is exactly ``repro_torch.core.tuners``;
    only the Measurement source differs (wall-clock byte counters instead
    of the simulator)."""

    def __init__(self, source, sla: SLA, cpu: Optional[CpuProfile] = None,
                 profile: Optional[NetworkProfile] = None,
                 max_workers: int = 16, depth: int = 8):
        self.source = source
        self.sla = sla
        self.cpu = cpu or CpuProfile()
        self.profile = profile or NetworkProfile()
        self.max_workers = max_workers
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._idx = 0
        self._idx_lock = threading.Lock()
        self._stop = threading.Event()
        self._workers: list = []
        self._ctl: Optional[threading.Thread] = None
        self._stats = FetchStats(t_start=time.monotonic())
        self._ts = TunerState(*host_tensors(
            tuners.init_tuner_state(2.0, 1, 0)))
        self._net = host_tensors(NetParams.from_profile(self.profile))
        self._sla_p = host_tensors(SLAParams.from_sla(sla))
        self._threads_target = 2
        #: (seconds since start, workers, cores, freq_idx) after each tick
        self.trajectory: list = []

    # -- worker pool ---------------------------------------------------
    def _worker(self, wid: int):
        while not self._stop.is_set():
            if wid >= self._threads_target:
                time.sleep(0.02)          # parked "channel"
                continue
            with self._idx_lock:
                idx = self._idx
                self._idx += 1
            shard = self.source.read_shard(idx)
            self._stats.bytes_fetched += shard.nbytes
            try:
                self.q.put((idx, shard), timeout=1.0)
            except queue.Full:
                with self._idx_lock:
                    self._idx = min(self._idx, idx)  # retry later

    def start(self):
        for wid in range(self.max_workers):
            t = threading.Thread(target=self._worker, args=(wid,),
                                 daemon=True)
            t.start()
            self._workers.append(t)
        self._ctl = threading.Thread(target=self._control_loop, daemon=True)
        self._ctl.start()
        return self

    def stop(self):
        """Stop and join the control thread and every worker thread, so
        that none is left inside torch when the interpreter exits (a
        thread running a torch op at teardown aborts the process).  The
        join ends within about a second: a worker waits at most 1 s in
        ``q.put``, the control loop wakes on the event.  A second call
        does nothing."""
        self._stop.set()
        threads = self._workers + ([self._ctl] if self._ctl else [])
        self._workers, self._ctl = [], None
        for t in threads:
            if t is not threading.current_thread():
                t.join()

    # -- the paper's controller, on real measurements ------------------
    def _control_loop(self):
        last_bytes = 0.0
        while not self._stop.wait(self.sla.timeout_s):
            now_bytes = self._stats.bytes_fetched
            mb = (now_bytes - last_bytes) / 1e6
            last_bytes = now_bytes
            tput = mb / self.sla.timeout_s

            cores, f = energy_model.operating_point(
                self.cpu, torch.tensor(self._stats.cores, dtype=torch.int32),
                torch.tensor(self._stats.freq_idx, dtype=torch.int32))
            util = float(energy_model.cpu_load(
                self.cpu, _f32(tput), cores, f,
                _f32(float(self._threads_target))))
            pw = float(energy_model.power_w(self.cpu, cores, f, _f32(util),
                                            _f32(tput)))
            self._stats.energy_j += pw * self.sla.timeout_s

            meas = tuners.Measurement(
                avg_tput=_f32(tput), energy_j=_f32(pw * self.sla.timeout_s),
                avg_power=_f32(pw),
                remaining_mb=_f32(1e6),             # streaming: "inf"
                cpu_load=_f32(util), interval_s=_f32(self.sla.timeout_s))
            self._ts = tuners.update(self._ts, meas, self._net, self.cpu,
                                     self._sla_p, scaling=True,
                                     policy=self.sla.policy)
            self._threads_target = int(np.clip(
                round(float(self._ts.num_ch)), 1, self.max_workers))
            self._stats.workers = self._threads_target
            self._stats.cores = int(self._ts.cores)
            self._stats.freq_idx = int(self._ts.freq_idx)
            self.trajectory.append((time.monotonic() - self._stats.t_start,
                                    self._stats.workers, self._stats.cores,
                                    self._stats.freq_idx))

    @property
    def stats(self) -> FetchStats:
        return self._stats

    def shards(self) -> Iterator[np.ndarray]:
        while not self._stop.is_set():
            idx, shard = self.q.get()
            yield shard


def batches(source, batch: int, seq: int, sla: Optional[SLA] = None,
            tuned: bool = True, vocab: int = 32000, *,
            fetcher: Optional[TunedFetcher] = None) -> Iterator[dict]:
    """Yield train batches {tokens, labels} of [B, T] int32 CPU tensors;
    labels are the tokens shifted by one.

    With ``tuned=True`` the shard fetch runs through a :class:`TunedFetcher`
    -- ``fetcher`` if given, not yet started (so that the caller can read
    its stats and trajectory), else a new one on ``sla`` -- which stops
    when the generator is closed."""
    need = batch * (seq + 1)
    buf = np.zeros((0,), np.int32)
    if tuned:
        fetcher = (fetcher or TunedFetcher(source, sla or SLA())).start()
        it = fetcher.shards()
    else:
        it = (source.read_shard(i) for i in itertools.count())
    try:
        for shard in it:
            buf = np.concatenate([buf, np.asarray(shard, np.int32)])
            while buf.size >= need:
                chunk, buf = buf[:need], buf[need:]
                arr = chunk.reshape(batch, seq + 1)
                yield {"tokens": torch.from_numpy(arr[:, :-1].copy()),
                       "labels": torch.from_numpy(arr[:, 1:].copy())}
    finally:
        if tuned:
            fetcher.stop()
