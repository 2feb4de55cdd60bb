"""LearnedController: trained policy params behind the Controller protocol
(the port of ``repro/learn/controller.py``).

Scenarios whose controllers have equal ``code()`` run as one lane batch,
and every per-scenario number flows through ``init``'s return value — but
there is no slot for policy weights there.  A learned controller's weights
therefore *select code*: ``code()`` returns a canonical instance that still
carries the params (on a card the tick kernel takes them as an input
table, :meth:`LearnedController.table`), and equality/hashing go by
a content digest of the weights — two controllers with bit-identical
params share one lane batch, retrained params get another, and stale
Experiment cache cells can never be served for new weights
(``scenario_key`` hashes the same content).  The digest is the JAX
package's (sha256 over names, shapes and float32 bytes), so a checkpoint
written by either package is the same controller in both.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api.controllers import ControllerInit
from repro_torch.core import heuristics, tuners
from repro_torch.core.types import SLA, SLAParams

from .policy import (PolicyConfig, apply_action, apply_policy,
                     config_from_params, featurize, init_policy)


def canonical_params(params) -> dict:
    """Flatten to a plain ``{name: float32 ndarray}`` dict (host-side);
    leaves may be tensors (on any device) or arrays."""
    if not isinstance(params, dict):
        raise TypeError(f"policy params must be a dict, "
                        f"got {type(params).__name__}")
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[str(k)] = np.asarray(v, np.float32)
    return out


def params_digest(params) -> str:
    """Content hash of a params dict: name, shape, and exact bytes."""
    h = hashlib.sha256()
    for name in sorted(params):
        a = np.ascontiguousarray(np.asarray(params[name], np.float32))
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True, eq=False)
class LearnedController:
    """A trained (or freshly initialized) policy as a Controller.

    ``params=None`` builds a deterministic seed-0 policy —
    :func:`init_policy` with ``torch.Generator().manual_seed(0)``; these
    are the port's own numbers, not the JAX package's (``jax.random``
    streams are not reproducible in torch) — useless for transfers but
    enough for registry round-trips and smoke tests.  The ``sla`` supplies
    the Algorithm-1 starting point (its ``policy`` field selects the
    initial cores/frequency, so a policy cloned from ME starts where ME
    starts), the controller-tick interval, and the ``delta_ch``/``max_ch``
    action scaling (as per-lane numbers, so it is not part of the code).
    """

    params: Any = None
    cfg: Optional[PolicyConfig] = None
    sla: SLA = SLA()
    label: Optional[str] = None

    tunes = True

    def __post_init__(self):
        cfg = self.cfg
        params = self.params
        if params is None:
            cfg = cfg or PolicyConfig()
            params = init_policy(cfg, torch.Generator().manual_seed(0))
        params = canonical_params(params)
        if cfg is None:
            cfg = config_from_params(params)
        object.__setattr__(self, "params", params)
        object.__setattr__(self, "cfg", cfg)
        object.__setattr__(self, "_digest", params_digest(params))
        object.__setattr__(self, "_on_device", {})
        object.__setattr__(self, "_tables", {})
        object.__setattr__(self, "_code", None)

    @property
    def name(self) -> str:
        return self.label or "learned"

    @property
    def timeout_s(self) -> float:
        return self.sla.timeout_s

    @property
    def digest(self) -> str:
        return self._digest

    def __eq__(self, other) -> bool:
        return (type(other) is LearnedController
                and self.cfg == other.cfg
                and self.sla == other.sla
                and self._digest == other._digest)

    def __hash__(self) -> int:
        return hash((self.cfg, self.sla, self._digest))

    def code(self) -> "LearnedController":
        # tick() reads only cfg + params from self; the SLA numerics arrive
        # via SLAParams, and the init operating point is numeric (state0) —
        # so the canonical instance keeps the weights (they ARE the code)
        # and drops everything else.  It is made once, so its device
        # copies of the weights live as long as this controller.
        if self.sla == SLA() and self.label is None:
            return self
        if self._code is None:
            object.__setattr__(self, "_code", LearnedController(
                params=self.params, cfg=self.cfg))
        return self._code

    def weights(self, device) -> dict:
        """The params as float32 tensors on ``device`` (uploaded once per
        device)."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = {
                k: torch.as_tensor(v, device=device)
                for k, v in self.params.items()}
        return self._on_device[device]

    def table(self, device) -> torch.Tensor:
        """The weights as the tick kernel's float32 table on ``device``:
        w0 (row-major), b0, w1, b1, ... (uploaded once per device, freed
        with the controller)."""
        device = torch.device(device)
        if device not in self._tables:
            n_layers = len(self.cfg.hidden) + 1
            flat = np.concatenate([self.params[f"{kind}{i}"].ravel()
                                   for i in range(n_layers)
                                   for kind in "wb"])
            self._tables[device] = torch.as_tensor(flat, device=device)
        return self._tables[device]

    def init(self, specs, profile, cpu) -> ControllerInit:
        params, chunked = heuristics.initialize(specs, profile, cpu,
                                                self.sla)
        num_ch0 = float(np.sum(np.asarray(params.cc)))
        state = tuners.init_tuner_state(num_ch0, int(params.cores),
                                        int(params.freq_idx))
        return ControllerInit(params, state, chunked,
                              SLAParams.from_sla(self.sla),
                              np.zeros(len(chunked), np.float32))

    def tick(self, state, meas, net, cpu, sla):
        feats = featurize(meas.avg_tput, meas.avg_power, meas.cpu_load,
                          meas.remaining_mb, state.num_ch, state.cores,
                          state.freq_idx, net=net, sla=sla, cpu=cpu)
        logits = apply_policy(self.cfg, self.weights(feats.device), feats)
        cls = torch.argmax(logits, dim=-1)
        num_ch, cores, freq_idx = apply_action(
            state.num_ch, state.cores, state.freq_idx, cls, sla=sla,
            cpu=cpu)
        # fsm doubles as a controller-tick counter (the FSM constants are
        # meaningless to a learned policy); the stochastic training wrapper
        # indexes its pre-drawn exploration noise with it.
        return state._replace(num_ch=num_ch, prev_num_ch=state.num_ch,
                              cores=cores, freq_idx=freq_idx,
                              fsm=state.fsm + 1)

    def channels(self, state, sim, static_w):
        return heuristics.redistribute_channels(state.num_ch,
                                                sim.remaining_mb)


# ------------------------------------------------------------ checkpoints --

def save_policy(ckpt_dir: str, params, *, step: int = 0) -> None:
    """Persist policy params with ``repro_torch.ckpt`` (atomic npz + meta,
    the JAX package's layout: the JAX package's ``load_policy`` reads it)."""
    from repro_torch import ckpt
    ckpt.save(ckpt_dir, step, {k: torch.from_numpy(v) for k, v in
                               canonical_params(params).items()})


def load_policy(ckpt_dir: str) -> dict:
    """Load the newest policy checkpoint written by :func:`save_policy` (or
    by the JAX package's ``save_policy``).

    Reads the npz + meta pair directly (no template tree needed — the flat
    param dict reconstructs from the checkpoint's own path list).
    """
    from repro_torch import ckpt
    steps = ckpt.available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no policy checkpoint under {ckpt_dir!r}")
    step_dir = os.path.join(ckpt_dir, f"step_{steps[-1]}")
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(step_dir, "arrays.npz")) as z:
        arrays = [z[f"a{i}"] for i in range(len(meta["paths"]))]
    return {path: np.asarray(a, np.float32)
            for path, a in zip(meta["paths"], arrays)}
