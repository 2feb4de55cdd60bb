"""EETT-throttled checkpoint writer (the port of
``repro/ckpt/tuned_writer.py``).

Checkpoint I/O competes with training ingest for host bandwidth.  This
writer applies the paper's *target-throughput* controller (Algorithm 6) to
the checkpoint stream: the client sets a target write bandwidth in the SLA,
and the controller tunes the number of concurrent writer "channels"
(threaded shard writers) every timeout — hitting the target with the fewest
streams, exactly as EETT hits a WAN target with the fewest TCP channels.
The controller is ``repro_torch.core.tuners.update`` on 0-d CPU tensors,
as the tuned fetcher (``repro_torch.data.pipeline.TunedFetcher``) runs it.

Shards are ``shard_<i>.npy``, one per leaf in ``jax.tree``'s order
(``repro_torch.tree``), bfloat16 stored as uint16 as
``repro_torch.ckpt.checkpoint`` stores it: the files equal the JAX
package's writer's for the same state.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core import tuners
from ..core.types import (CpuProfile, NetParams, NetworkProfile, SLA,
                          SLAParams, SLAPolicy, TunerState, host_tensors)
from ..tree import leaves
from .checkpoint import _host


def _f32(x):
    return torch.tensor(np.float32(x))


def _host_array(a) -> np.ndarray:
    """A leaf as the array its shard holds (bfloat16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return _host(a)[0]
    return np.asarray(a)


class TunedCheckpointWriter:
    """Writes array shards with an EETT-governed worker pool."""

    def __init__(self, target_mbps: float = 200.0, max_writers: int = 8,
                 timeout_s: float = 0.25, cpu: Optional[CpuProfile] = None):
        self.sla = SLA(policy=SLAPolicy.TARGET_THROUGHPUT,
                       target_tput_mbps=target_mbps, timeout_s=timeout_s,
                       max_ch=max_writers, delta_ch=1)
        self.cpu = cpu or CpuProfile()
        self.profile = NetworkProfile(name="local-disk",
                                      bandwidth_mbps=2000.0)
        self.max_writers = max_writers
        self._ts = TunerState(*host_tensors(tuners.init_tuner_state(1.0, 1,
                                                                    0)))
        self._net = host_tensors(NetParams.from_profile(self.profile))
        self._sla_p = host_tensors(SLAParams.from_sla(self.sla))
        self._target = 1
        self._bytes = 0.0
        self._lock = threading.Lock()

    def tick(self, tput_mbps: float) -> int:
        """One controller tick on the write rate measured over the last
        timeout (MB/s): the tuner's new state, and the writer count it
        allows (its channel count, clipped to ``[1, max_writers]``)."""
        meas = tuners.Measurement(
            avg_tput=_f32(tput_mbps),
            energy_j=_f32(1.0), avg_power=_f32(1.0),
            remaining_mb=_f32(1e6),
            cpu_load=_f32(min(tput_mbps / 500.0, 1.0)),
            interval_s=_f32(self.sla.timeout_s))
        self._ts = tuners.update(self._ts, meas, self._net, self.cpu,
                                 self._sla_p, scaling=False,
                                 policy=self.sla.policy)
        self._target = int(np.clip(round(float(self._ts.num_ch)), 1,
                                   self.max_writers))
        return self._target

    def write(self, out_dir: str, state) -> dict:
        """Blocking sharded write of a tree of tensors or arrays; returns
        stats.  Every writer thread is joined before this returns or
        raises; an error in a writer is raised here."""
        os.makedirs(out_dir, exist_ok=True)
        arrays = [_host_array(a) for a in leaves(state)]
        work: queue.Queue = queue.Queue()
        for i, a in enumerate(arrays):
            work.put((i, a))

        stop = threading.Event()
        errors: list = []
        t0 = time.monotonic()

        def writer(wid: int):
            try:
                while not stop.is_set():
                    if work.empty():
                        return
                    if wid >= self._target:      # parked "channel"
                        time.sleep(0.01)
                        continue
                    try:
                        i, a = work.get_nowait()
                    except queue.Empty:
                        return
                    np.save(os.path.join(out_dir, f"shard_{i}.npy"), a)
                    with self._lock:
                        self._bytes += a.nbytes
            except BaseException as e:           # raised by write()
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(w,), daemon=True)
                   for w in range(self.max_writers)]
        ticks = 0
        try:
            for t in threads:
                t.start()
            last = 0.0
            while (not errors and any(t.is_alive() for t in threads)
                   and not work.empty()):
                time.sleep(self.sla.timeout_s)
                ticks += 1
                cur = self._bytes
                tput = (cur - last) / 1e6 / self.sla.timeout_s
                last = cur
                self.tick(tput)
        finally:
            stop.set()
            for t in threads:
                if t.ident is not None:
                    t.join()
        if errors:
            raise errors[0]
        dt = time.monotonic() - t0
        return {"bytes": self._bytes, "seconds": dt,
                "mbps": self._bytes / 1e6 / max(dt, 1e-9),
                "final_writers": self._target, "ticks": ticks}
