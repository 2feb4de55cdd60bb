"""Rollout harness: drive the engine as a batched environment (the port of
``repro/learn/rollout.py``).

Two modes:

* **Teacher capture** (:func:`run_observed`, :func:`teacher_dataset`) —
  run any scenarios through the engine with the ``observe=True`` hook and
  harvest per-tick ``Observation`` traces: window throughput/power,
  operating point, contention share, and the action deltas the controller
  applied.  Controller ticks become (features, action-class) pairs — the
  behavior-cloning dataset.

* **Policy rollout** (:func:`make_policy_rollout`) — a lane batch whose
  controller holds the *current* policy params, so a policy-gradient loop
  re-rolls its lanes per update.  Exploration is Gumbel-max sampling from
  pre-drawn noise: the tuner state's ``fsm`` slot counts controller ticks
  and indexes the lane's noise table, which makes the sampled action a
  deterministic function of (params, noise) — the PG loss replays the same
  argmax to recover the sampled class and its log-probability.

Both run on the engine's ``reference`` executor (the eager tick loop) on
the given device: the tick kernel has no observation outputs and no
sampled controller, as the JAX package's Pallas kernel has neither (JAX
runs these as XLA scans of the same step).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.api import scenario as _scenario
from repro_torch.core import engine, heuristics, tickstate
from repro_torch.core._f32 import ftz

from .policy import (PolicyConfig, action_classes, apply_action,
                     apply_policy, featurize)


class ObservedRun(NamedTuple):
    """One scenario's observed rollout (numpy leaves, no lane axis)."""

    prep: _scenario._Prepared
    sim: object            # final SimState
    metrics: object        # TickMetrics [n_steps]
    obs: engine.Observation    # [n_steps]


def _host(tree):
    return _scenario._np_tree(lambda x: x.contiguous().cpu().numpy(), tree)


def run_observed(scenarios: Sequence, *, device=None) -> list[ObservedRun]:
    """Run scenarios through the engine with the observation hook on.

    Mirrors ``repro_torch.api.sweep``'s grouping (pad partitions, stack,
    one lane batch per code group) on ``device`` (default ``"cuda"``);
    results come back in input order.  A group the sweep would send to the
    kernel runs on the ``reference`` executor (the kernel has no
    observation outputs).
    """
    dev = _scenario.resolve_device(device)
    prepared, groups = _scenario._prepare_groups(scenarios, dev)
    results: list = [None] * len(prepared)
    for key, idxs in groups.items():
        runner = engine.get_runner(key.ctrl_code, key.env_code, key.cpu,
                                   key.n_steps, key.dt, key.ctrl_every,
                                   "reference", observe=True)
        sim, _, metrics, obs = map(_host, runner(
            _scenario._stack_group(prepared, idxs, dev)))
        for b, i in enumerate(idxs):
            results[i] = ObservedRun(prepared[i], *[
                _scenario._np_tree(lambda x, b=b: x[b], t)
                for t in (sim, metrics, obs)])
    return results


def teacher_dataset(scenarios: Sequence, *, max_samples: int | None = None,
                    device=None):
    """Behavior-cloning dataset from heuristic-controller rollouts.

    Returns ``(feats [N, F] float32, labels [N, n_heads] int32)`` numpy
    arrays — one row per live controller tick, features computed on
    ``device`` with the same :func:`repro_torch.learn.policy.featurize`
    the learned controller runs at inference.  ``max_samples`` truncates
    deterministically (front-first).
    """
    dev = _scenario.resolve_device(device)
    feats_out, labels_out = [], []
    for run in run_observed(scenarios, device=dev):
        obs = run.obs
        mask = np.asarray(obs.is_ctrl, bool)
        if not mask.any():
            continue
        o = engine.Observation(*[torch.as_tensor(x, device=dev)
                                 for x in obs])
        feats = featurize(o.avg_tput, o.avg_power, o.cpu_load,
                          o.remaining_mb, o.num_ch, o.cores, o.freq_idx,
                          net=run.prep.inputs.net, sla=run.prep.inputs.sla,
                          cpu=run.prep.key.cpu)
        labels = action_classes(o.d_num_ch, o.d_cores, o.d_freq_idx)
        feats_out.append(feats.cpu().numpy()[mask])
        labels_out.append(labels.cpu().numpy()[mask])
    if not feats_out:
        raise ValueError("no controller ticks observed — do the scenarios "
                         "use a tuning controller and a horizon >= one "
                         "controller interval?")
    feats = np.concatenate(feats_out).astype(np.float32)
    labels = np.concatenate(labels_out).astype(np.int32)
    if max_samples is not None:
        feats, labels = feats[:max_samples], labels[:max_samples]
    return feats, labels


class _SampledPolicy:
    """Policy controller over the current params with Gumbel-max
    exploration, for the PG rollout only (never hashed or cached, so never
    grouped or sent to the kernel).  ``state.fsm`` counts controller ticks
    (the engine gates ticks on liveness, so the counter is dense from 0)
    and selects each lane's noise row.
    """

    tunes = True
    name = "learned-sample"

    def __init__(self, cfg: PolicyConfig, params, noise):
        self.cfg = cfg
        self.params = params
        self.noise = noise          # [lanes, n_ctrl, n_heads, n_classes]

    def tick(self, state, meas, net, cpu, sla):
        feats = featurize(meas.avg_tput, meas.avg_power, meas.cpu_load,
                          meas.remaining_mb, state.num_ch, state.cores,
                          state.freq_idx, net=net, sla=sla, cpu=cpu)
        logits = apply_policy(self.cfg, self.params, feats)
        k = torch.clamp(state.fsm.long(), max=self.noise.shape[1] - 1)
        lanes = torch.arange(self.noise.shape[0], device=k.device)
        gumbel = self.noise[lanes, k]
        cls = torch.argmax(ftz(logits + gumbel), dim=-1)
        num_ch, cores, freq_idx = apply_action(
            state.num_ch, state.cores, state.freq_idx, cls, sla=sla,
            cpu=cpu)
        return state._replace(num_ch=num_ch, prev_num_ch=state.num_ch,
                              cores=cores, freq_idx=freq_idx,
                              fsm=state.fsm + 1)

    def channels(self, state, sim, static_w):
        return heuristics.redistribute_channels(state.num_ch,
                                                sim.remaining_mb)


def n_ctrl_ticks(n_steps: int, ctrl_every: int) -> int:
    """Controller ticks in a full horizon (ticks fire at step indices
    ``ctrl_every - 1, 2*ctrl_every - 1, ...``)."""
    return max(n_steps // ctrl_every, 1)


def make_policy_rollout(cfg: PolicyConfig, env, cpu, *, n_steps: int,
                        dt: float, ctrl_every: int):
    """Batched full-horizon rollout ``(params, noise, inputs) -> (sim,
    metrics, obs)`` with the policy sampling via Gumbel noise.

    ``inputs`` is a lane batch of ``ScanInputs`` tensors on one device,
    ``noise`` ``[lanes, n_ctrl_ticks, n_heads, n_classes]`` on the same
    device (zeros for a greedy, argmax rollout).  The outputs are tensors
    outside inference mode (``metrics.done`` bool), ready for a loss.
    """
    from repro_torch.kernels.tick_loop import tick_loop_reference

    def rollout(params, noise, inp):
        if inp.bw.shape[-1] != n_steps:
            raise ValueError(f"bw has {inp.bw.shape[-1]} ticks, the rollout "
                             f"was built for {n_steps}")
        ctrl = _SampledPolicy(cfg, {k: v.detach() for k, v in
                                    params.items()}, noise)
        prow, f0, i0 = engine.pack_batch(env, inp)
        f32, i32, metrics, obs = tick_loop_reference(
            ctrl, env, cpu, prow, inp.bw, f0, i0, dt=dt,
            ctrl_every=ctrl_every, observe=True)
        sim, _ = tickstate.TickLayout(inp.pp.shape[-1]).unpack_state(
            f32.clone(), i32.clone())
        metrics = type(metrics)(*[m.clone() for m in metrics])
        obs = engine.Observation(*[o.clone() for o in obs])
        return sim, metrics._replace(done=metrics.done != 0), obs

    return rollout
