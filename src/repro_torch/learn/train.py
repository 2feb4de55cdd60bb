"""Trainers for learned transfer controllers (the port of
``repro/learn/train.py``).

* :func:`bc_train` — behavior cloning: cross-entropy over (observation,
  teacher-action) pairs captured by the rollout harness, differentiated
  with ``torch.autograd`` and optimized with ``repro_torch.optim.adamw``.
* :func:`pg_train` — REINFORCE on an energy·delay objective with a
  throughput-floor penalty: stochastic rollouts through the engine
  (Gumbel-max exploration), advantage-normalized returns, and a replayed
  log-probability pass that recovers each sampled action from the same
  (logits + noise) argmax the rollout executed.

Determinism: every entry point takes an explicit ``key`` — a
``torch.Generator`` (:func:`seed_everything` makes the root one) or an int
seed — and derives its own CPU generators from it: the init, the minibatch
indices and the Gumbel noise are drawn on the CPU and then moved to the
device, so they do not depend on the device.  Nothing else draws
randomness, so a (seed, data, config, device) tuple reproduces parameters
bit for bit.  ``torch`` draws other numbers than ``jax.random`` from the
same seed: training is held to the reference's acceptance metrics, not to
its parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api import scenario as _scenario
from repro_torch.core._f32 import ftz
from repro_torch.core.types import SLA, NetParams, SLAParams
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init, adamw_update

from .controller import LearnedController, canonical_params
from .policy import PolicyConfig, apply_policy, featurize, init_policy
from .rollout import make_policy_rollout, n_ctrl_ticks

#: The smallest normal float32 (``jax.random.gumbel``'s lower bound on u).
_TINY = float(np.finfo(np.float32).tiny)


def seed_everything(seed: int) -> torch.Generator:
    """One integer seed -> the root ``torch.Generator`` (on the CPU) every
    learn entry point derives from.  Also seeds numpy's legacy generator so
    any host-side shuffling downstream of the trainers is pinned too."""
    np.random.seed(seed & 0xFFFFFFFF)
    return torch.Generator().manual_seed(seed)


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def _split(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` independent CPU generators seeded from ``gen``'s stream."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen, dtype=torch.int64)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _default_opt(steps: int, lr: float) -> AdamWConfig:
    return AdamWConfig(lr=lr, weight_decay=1e-4, grad_clip=1.0,
                       warmup_steps=max(steps // 20, 1), total_steps=steps,
                       min_lr_frac=0.05)


def _cross_entropy(cfg, params, feats, labels):
    logits = apply_policy(cfg, params, feats)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return nll.mean()


def _step(opt, loss_fn, params, opt_state):
    """One AdamW step on ``loss_fn(params)``: (params, state, loss)."""
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(live)
    names = sorted(live)
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                [live[k] for k in names])))
    params, opt_state, _ = adamw_update(
        opt, grads, opt_state, {k: v.detach() for k, v in live.items()})
    return params, opt_state, loss.detach()


def bc_train(feats, labels, *, key, cfg: PolicyConfig = PolicyConfig(),
             steps: int = 400, batch_size: int = 256, lr: float = 3e-3,
             opt: Optional[AdamWConfig] = None, device=None):
    """Fit the policy to teacher (features, action-class) pairs on
    ``device`` (default ``"cuda"``).

    Returns ``(params, history)``: numpy params, ``history["loss"]`` the
    per-step minibatch cross-entropy.  Bit-deterministic in (key, data,
    config, device).
    """
    dev = _scenario.resolve_device(device)
    feats = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    labels = torch.as_tensor(np.asarray(labels), device=dev).long()
    n = feats.shape[0]
    batch = min(batch_size, n)
    opt = opt or _default_opt(steps, lr)
    k_init, k_train = _split(_generator(key), 2)
    params = {k: v.to(dev) for k, v in init_policy(cfg, k_init).items()}
    idx = torch.randint(0, n, (steps, batch), generator=k_train).to(dev)
    opt_state = adamw_init(params)
    losses = []
    for s in range(steps):
        b = idx[s]
        params, opt_state, loss = _step(
            opt, lambda p: _cross_entropy(cfg, p, feats[b], labels[b]),
            params, opt_state)
        losses.append(loss)
    hist = (torch.stack(losses).cpu().numpy() if losses
            else np.zeros((0,), np.float32))
    return canonical_params(params), {"loss": hist}


@dataclasses.dataclass(frozen=True)
class PGConfig:
    """REINFORCE hyper-parameters (objective: minimize energy·delay,
    penalized when average throughput falls below the floor)."""

    steps: int = 30
    lr: float = 1e-3
    tput_floor_mbps: float = 0.0
    floor_penalty: float = 5.0


def _prepare_lanes(scenarios: Sequence, controller: LearnedController,
                   device):
    """Prepare scenarios as PG lanes (one shared engine code group)."""
    prepared, groups = _scenario._prepare_groups(
        [dataclasses.replace(sc, controller=controller) for sc in scenarios],
        device)
    if len(groups) != 1:
        raise ValueError(
            "PG lanes must share one engine code group (same cpu, horizon, "
            f"dt, controller interval and partition count); got "
            f"{len(groups)}")
    (key, idxs), = groups.items()
    return key, _scenario._stack_group(prepared, idxs, device)


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with u uniform in
    [tiny, 1), drawn on the CPU."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp_min(u, _TINY)))


def pg_train(scenarios: Sequence, *, key,
             cfg: PolicyConfig = PolicyConfig(),
             params=None, sla: SLA = SLA(),
             pg: PGConfig = PGConfig(),
             opt: Optional[AdamWConfig] = None, device=None):
    """REINFORCE over batched engine rollouts on ``device`` (default
    ``"cuda"``).

    ``scenarios`` are run as parallel lanes (their ``controller`` field is
    replaced by the in-training policy); ``params`` warm-starts from a BC
    fit when given.  Returns ``(params, history)`` where history tracks
    the mean energy·delay cost and penalty per update.
    """
    dev = _scenario.resolve_device(device)
    gen = _generator(key)
    if params is None:
        k_init, = _split(gen, 1)
        params = init_policy(cfg, k_init)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in canonical_params(params).items()}
    controller = LearnedController(params=params, cfg=cfg, sla=sla)
    gkey, inputs = _prepare_lanes(scenarios, controller, dev)
    n_steps, dt, ctrl_every = gkey.n_steps, gkey.dt, gkey.ctrl_every
    n_lanes = int(inputs.bw.shape[0])
    n_ctrl = n_ctrl_ticks(n_steps, ctrl_every)
    rollout = make_policy_rollout(cfg, gkey.env_code, gkey.cpu,
                                  n_steps=n_steps, dt=dt,
                                  ctrl_every=ctrl_every)
    opt = opt or _default_opt(pg.steps, pg.lr)
    net_b = NetParams(*[x[:, None] for x in inputs.net])
    sla_b = SLAParams(*[x[:, None] for x in inputs.sla])
    noise_shape = (n_lanes, n_ctrl, cfg.n_heads, cfg.n_classes)

    def lane_cost(sim, metrics):
        finished = metrics.done[:, -1]
        first = torch.argmax(metrics.done.to(torch.int32), dim=-1)
        t_done = torch.where(finished, (first + 1).to(torch.float32) * dt,
                             torch.full_like(sim.energy_j, n_steps * dt))
        tput = ftz(torch.div(sim.bytes_moved, t_done.clamp_min(1e-9)))
        ed = ftz(sim.energy_j * t_done)
        floor = pg.tput_floor_mbps
        if floor > 0.0:
            pen = ftz(torch.div(torch.clamp_min(floor - tput, 0.0),
                                torch.full_like(tput, max(floor, 1e-9))))
        else:
            pen = torch.zeros_like(tput)
        return ed, pen

    sel = slice(ctrl_every - 1, n_steps, ctrl_every)

    def update(params, opt_state, ed_ref, noise):
        sim, metrics, obs = rollout(params, noise, inputs)
        ed, pen = lane_cost(sim, metrics)
        cost = torch.div(ed, ed_ref) + pg.floor_penalty * pen
        adv = torch.div(cost - cost.mean(),
                        cost.std(correction=0) + 1e-6)
        feats = featurize(obs.avg_tput[:, sel], obs.avg_power[:, sel],
                          obs.cpu_load[:, sel], obs.remaining_mb[:, sel],
                          obs.num_ch[:, sel], obs.cores[:, sel],
                          obs.freq_idx[:, sel], net=net_b, sla=sla_b,
                          cpu=gkey.cpu)
        mask = obs.is_ctrl[:, sel].to(torch.float32)
        noise_ct = noise[:, :feats.shape[1]]

        def loss_fn(p):
            logits = apply_policy(cfg, p, feats)
            cls = torch.argmax(ftz(logits.detach() + noise_ct), dim=-1)
            logp = torch.log_softmax(logits, dim=-1)
            taken = torch.gather(logp, -1, cls[..., None])[..., 0].sum(-1)
            lane_logp = (taken * mask).sum(-1)
            return (adv * lane_logp).mean()

        params, opt_state, loss = _step(opt, loss_fn, params, opt_state)
        stats = torch.stack([loss, cost.mean(), ed.mean(), pen.mean()])
        return params, opt_state, stats

    # Reference energy·delay from a greedy pass with the starting params:
    # normalizes the return scale so lr/penalty are workload-independent.
    zeros = torch.zeros(noise_shape, dtype=torch.float32, device=dev)
    ed0, _ = lane_cost(*rollout(params, zeros, inputs)[:2])
    ed_ref = torch.clamp_min(ed0.mean(), 1e-6)

    history = []
    opt_state = adamw_init(params)
    for k in _split(gen, pg.steps):
        noise = _gumbel(k, noise_shape).to(dev)
        params, opt_state, stats = update(params, opt_state, ed_ref, noise)
        history.append(stats)
    hist = (torch.stack(history).cpu().numpy() if history
            else np.zeros((0, 4), np.float32))
    return canonical_params(params), {
        "loss": hist[:, 0], "cost": hist[:, 1], "energy_delay": hist[:, 2],
        "floor_penalty": hist[:, 3], "ed_ref": float(ed_ref)}
