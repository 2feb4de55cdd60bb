"""Continuous-batching serving scheduler with SLA admission control (the
port of ``repro/serve/scheduler.py``).

Slot-based continuous batching: a fixed pool of batch slots shares one
batched decode step; finished sequences free their slot and a queued
request is prefilled into it.  Admission is governed by the paper's
controllers -- the number of *admitted* slots is the "channel count":

  * EETT: hold a target tokens/s with the fewest active slots (energy);
  * EEMT: maximize tokens/s, backing off when adding slots stops helping
    (the serving analogue of over-concurrency).

The model and its per-row KV caches live on the serving device.  The
tuner's handful of scalars stay in CPU tensors: admission is host control
logic, run once per ``timeout_s``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..api.scenario import resolve_device
from ..core import tuners
from ..core.types import (CpuProfile, NetParams, NetworkProfile, SLA,
                          SLAParams, SLAPolicy, TunerState, host_tensors)
from ..kernels.flash_attention.ops import check_executor
from ..models import ModelBundle, lm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, bundle: ModelBundle, params, *, slots: int = 8,
                 max_len: int = 256, sla: Optional[SLA] = None, device=None,
                 executor: str = "auto"):
        check_executor(executor)
        if bundle.cfg.family != "dense":
            # JAX's batcher also needs the dense family's stacked caches
            # (scheduler.py:12-13, :50).
            raise NotImplementedError(
                f"ContinuousBatcher serves the dense family (per-row KV "
                f"caches), not {bundle.cfg.family!r}")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.executor = executor
        self.sla = sla or SLA(policy=SLAPolicy.MAX_THROUGHPUT,
                              max_ch=slots, delta_ch=1, timeout_s=0.25)
        # per-row caches: each slot writes at its own position
        self.state = lm.init_caches(bundle.cfg, slots, max_len, per_row=True,
                                    device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int32)
        self.queue: List[Request] = []
        self.last_tok = np.zeros((slots, 1), np.int32)
        # admission controller ("channels" = admitted slots)
        self._ts = TunerState(*host_tensors(
            tuners.init_tuner_state(max(slots // 2, 1), 1, 0)))
        self.admitted = max(slots // 2, 1)
        self._tok_count = 0
        self._t_last = time.monotonic()
        self._cpu = CpuProfile()
        self._net = host_tensors(NetParams.from_profile(
            NetworkProfile(name="serve", bandwidth_mbps=1e9)))
        self._sla_p = host_tensors(SLAParams.from_sla(self.sla))

    # ------------------------------------------------------ device steps --
    def _decode(self, toks, pos, live):
        """One batched decode step; only the live rows' caches are written
        (frozen slots keep their state)."""
        rows = torch.as_tensor(np.flatnonzero(live), device=self.device)
        kw = {self.bundle.state_kwarg: dict(self.state, rows=rows)}
        logits, new_state, _ = self.bundle.forward(
            self.params, toks, positions=pos, executor=self.executor, **kw)
        self.state = new_state
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def _prefill(self, slot: int, prompt):
        """Prefill one request straight into batch slot ``slot`` and return
        its last position's logits [1, V]: the slot's cache row, a view of
        the batch cache, is an empty per-row cache.  Stale entries past the
        prompt, left by the slot's previous request, are unreachable under
        the causal mask by absolute position, as in JAX (whose fresh row
        holds zeros there)."""
        st1 = {"k": self.state["k"][:, slot:slot + 1],
               "v": self.state["v"][:, slot:slot + 1], "idx": 0,
               "per_row": True}
        kw = {self.bundle.state_kwarg: st1}
        logits, _, _ = self.bundle.forward(
            self.params, prompt, logits_slice=1, executor=self.executor, **kw)
        return logits[:, -1]

    # -------------------------------------------------------------- API ---
    def submit(self, req: Request):
        self.queue.append(req)

    def _insert(self, slot: int, req: Request):
        prompt = torch.as_tensor(np.asarray(req.prompt)[None],
                                 device=self.device)
        tok = int(torch.argmax(self._prefill(slot, prompt)[0]))
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_tok[slot, 0] = tok
        req.out.append(tok)

    @torch.no_grad()
    def step(self):
        """Admit + one batched decode step. Returns #tokens produced."""
        # admission: fill free slots up to the admitted budget
        n_active = sum(r is not None for r in self.active)
        for s in range(self.slots):
            if n_active >= self.admitted or not self.queue:
                break
            if self.active[s] is None:
                self._insert(s, self.queue.pop(0))
                n_active += 1

        live_mask = np.array([r is not None for r in self.active], bool)
        if not live_mask.any():
            return 0

        toks = torch.as_tensor(self.last_tok, device=self.device)
        pos = torch.as_tensor(self.pos[:, None].astype(np.int64),
                              device=self.device)
        nxt = self._decode(toks, pos, live_mask).cpu().numpy()

        produced = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            self.last_tok[s, 0] = int(nxt[s])
            self.pos[s] += 1
            produced += 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.done = True
                self.active[s] = None
        self._tok_count += produced
        self._maybe_tune()
        return produced

    def _maybe_tune(self):
        now = time.monotonic()
        dt = now - self._t_last
        if dt < self.sla.timeout_s:
            return
        tput = self._tok_count / dt          # tokens/s as "MB/s" metric

        def f32(x):
            return torch.tensor(np.float32(x))
        meas = tuners.Measurement(
            avg_tput=f32(tput), energy_j=f32(dt), avg_power=f32(1.0),
            remaining_mb=f32(1e6),
            cpu_load=f32(min(sum(r is not None for r in self.active)
                             / self.slots, 1.0)),
            interval_s=f32(dt))
        self._ts = tuners.update(self._ts, meas, self._net, self._cpu,
                                 self._sla_p, scaling=False,
                                 policy=self.sla.policy)
        self.admitted = int(np.clip(round(float(self._ts.num_ch)), 1,
                                    self.slots))
        self._tok_count = 0
        self._t_last = now

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps
