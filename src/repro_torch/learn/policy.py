"""Policy network for learned transfer controllers (the port of
``repro/learn/policy.py``).

A small MLP maps normalized per-tick observations to three categorical
heads — channel, core, and frequency *deltas* — the exact ±1-step action
space the paper's Algorithm-3 load control and the SLA tuners move in
(channels move in units of the SLA's ``delta_ch``).  Matching the teacher
action space is what makes behavior cloning a per-tick classification
problem: the label of a controller tick is just the sign of the delta the
teacher applied.

Parameters are a flat ``{"w0": [in, out], "b0": [out], ...}`` dict, the
JAX package's names and shapes.  Everything here works on tensors of any
leading shape — ``[B]`` lanes inside the engine tick, ``[lanes, ticks]`` or
``[N]`` batches in training — and is held bit for bit to the CUDA tick
kernel's learned controller (``kernels/csrc/tick_loop.cu``), so:

* :func:`apply_policy` accumulates each layer in the kernel's order:
  ``x[0] w[0, j]``, then ``+ x[k] w[k, j]`` for k = 1, 2, ... and the bias
  last, every product and sum rounded on its own (no ``h @ w``: a BLAS
  sums in its own order) and float32 subnormals flushed, as the kernel's
  ``-ftz=true`` does;
* every division in :func:`featurize` is tensor by tensor (PyTorch turns a
  division by a Python scalar into a multiplication by its reciprocal).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core._f32 import ftz
from repro_torch.core.types import CpuProfile

# Head order is part of the trained-params contract (see Observation's
# d_num_ch / d_cores / d_freq_idx capture in repro_torch.core.engine).
HEADS: Tuple[str, ...] = ("d_num_ch", "d_cores", "d_freq_idx")
N_HEADS = 3
N_CLASSES = 3            # {-1, 0, +1} per head
N_FEATURES = 9


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static architecture of the policy MLP (hashable)."""

    obs_dim: int = N_FEATURES
    hidden: Tuple[int, ...] = (32, 32)
    n_heads: int = N_HEADS
    n_classes: int = N_CLASSES

    @property
    def out_dim(self) -> int:
        return self.n_heads * self.n_classes


def init_policy(cfg: PolicyConfig, generator: torch.Generator) -> dict:
    """Deterministic (per generator state) MLP init: 1/sqrt(fan_in) normal
    weights, zero biases, float32 tensors on the CPU.  Returns a flat
    ``{"w0": .., "b0": .., ...}`` dict.  ``torch`` draws other numbers than
    ``jax.random`` from the same seed."""
    sizes = (cfg.obs_dim,) + tuple(cfg.hidden) + (cfg.out_dim,)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = 1.0 / np.sqrt(np.float32(fan_in))
        params[f"w{i}"] = (torch.randn((fan_in, fan_out), generator=generator,
                                       dtype=torch.float32) * float(scale))
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=torch.float32)
    return params


def config_from_params(params) -> PolicyConfig:
    """Recover the architecture from parameter shapes (checkpoints store
    only the params; head/class counts are fixed by the action space)."""
    n_layers = len(params) // 2
    sizes = [int(tuple(params[f"w{i}"].shape)[0]) for i in range(n_layers)]
    out = int(tuple(params[f"w{n_layers - 1}"].shape)[1])
    if out != N_HEADS * N_CLASSES:
        raise ValueError(f"policy output dim {out} != "
                         f"{N_HEADS}x{N_CLASSES} action logits")
    return PolicyConfig(obs_dim=sizes[0], hidden=tuple(sizes[1:]))


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def apply_policy(cfg: PolicyConfig, params, feats: torch.Tensor):
    """MLP forward: [..., obs_dim] features -> [..., n_heads, n_classes]
    logits, each layer summed sequentially over its inputs (see the module
    docstring)."""
    h = feats
    n_layers = len(cfg.hidden) + 1
    for i in range(n_layers):
        w = _on(params[f"w{i}"], h.device)
        b = _on(params[f"b{i}"], h.device)
        acc = ftz(h[..., 0:1] * w[0])
        for k in range(1, w.shape[0]):
            acc = ftz(acc + ftz(h[..., k:k + 1] * w[k]))
        h = ftz(acc + b)
        if i < n_layers - 1:
            h = ftz(torch.tanh(h))
    return h.reshape(h.shape[:-1] + (cfg.n_heads, cfg.n_classes))


def _div(num: torch.Tensor, den) -> torch.Tensor:
    """``num / den`` as a float32 division, tensor by tensor."""
    if not isinstance(den, torch.Tensor):
        den = torch.full_like(num, float(den))
    return ftz(torch.div(num, den))


def featurize(avg_tput, avg_power, cpu_load, remaining_mb, num_ch, cores,
              freq_idx, *, net, sla, cpu: CpuProfile):
    """Normalize raw per-tick observations into the policy input vector
    ``[..., 9]``.

    The observations are tensors (or numpy arrays, placed on
    ``avg_tput``'s device) of one matching shape; ``net``/``sla`` are
    ``NetParams``/``SLAParams`` views broadcastable to it, ``cpu`` the
    static profile.  All quantities a ``LearnedController.tick`` can see at
    runtime — the ``Observation`` capture's ``bw_scale`` (contention share)
    is recorded for analysis but deliberately NOT a feature, since the
    controller cannot observe it in deployment.
    """
    avg_tput = torch.as_tensor(avg_tput, dtype=torch.float32)
    dev = avg_tput.device
    bw = torch.clamp_min(_on(net.bandwidth_mbps, dev), 1e-6)
    n_freq = len(cpu.freq_levels_ghz)
    remaining = torch.clamp_min(_on(remaining_mb, dev), 0.0)
    feats = [
        torch.clamp(_div(avg_tput, bw), 0.0, 2.0),
        _div(_on(avg_power, dev), 40.0),
        _on(cpu_load, dev),
        _div(ftz(torch.log1p(remaining)), 10.0),
        _div(_on(num_ch, dev), torch.clamp_min(_on(sla.max_ch, dev), 1.0)),
        _div(_on(cores, dev), float(cpu.num_cores)),
        _div(_on(freq_idx, dev), float(max(n_freq - 1, 1))),
        torch.clamp(_div(_on(sla.target_tput_mbps, dev), bw), 0.0, 2.0),
        _div(ftz(torch.log10(bw)), 4.0),
    ]
    return torch.stack(torch.broadcast_tensors(*feats), dim=-1)


def apply_action(num_ch, cores, freq_idx, cls, *, sla, cpu: CpuProfile):
    """Apply per-head action classes (0/1/2 -> -1/0/+1 steps) to an
    operating point, clipped to the valid range.  Channel moves are scaled
    by the SLA's ``delta_ch``, mirroring the heuristic tuners.  Returns
    (num_ch float32, cores int32, freq_idx int32)."""
    num_ch = torch.as_tensor(num_ch, dtype=torch.float32)
    dev = num_ch.device
    d = torch.as_tensor(cls, device=dev).to(torch.int32) - 1
    delta_ch = _on(sla.delta_ch, dev)
    max_ch = _on(sla.max_ch, dev)
    step = ftz(num_ch + d[..., 0].to(torch.float32) * delta_ch)
    num_ch2 = torch.minimum(torch.clamp_min(step, 1.0), max_ch)
    cores = torch.as_tensor(cores, device=dev)
    freq_idx = torch.as_tensor(freq_idx, device=dev)
    cores2 = torch.clamp(cores + d[..., 1], 1, cpu.num_cores)
    freq2 = torch.clamp(freq_idx + d[..., 2], 0,
                        len(cpu.freq_levels_ghz) - 1)
    return num_ch2, cores2.to(torch.int32), freq2.to(torch.int32)


def action_classes(d_num_ch, d_cores, d_freq_idx):
    """Teacher deltas -> per-head classes (sign + 1, int32), the BC labels.
    Large slow-start jumps collapse to their direction, which is the only
    move the policy's action space can express."""
    d_num_ch = torch.as_tensor(d_num_ch)
    dev = d_num_ch.device
    cls = torch.stack([
        torch.sign(_on(d_num_ch, dev)),
        torch.sign(_on(d_cores, dev)),
        torch.sign(_on(d_freq_idx, dev)),
    ], dim=-1)
    return (cls + 1.0).to(torch.int32)
