"""Carry state between the JAX package and this port.

The JAX package's host-side values are numpy: ``ScanInputs`` after
``repro.api.scenario._prepare`` (``.inputs``), ``SimState`` / ``TunerState``
rows, the packed ``TickLayout`` rows.  :func:`to_torch` turns such a value —
an array, or a NamedTuple of them, nested — into the port's tensors on the
device the caller picks, mapping each NamedTuple to the port's class of the
same name (``repro_torch.core`` types and the engine's ``ScanInputs``).
:func:`to_numpy` goes the other way, to numpy leaves (optionally rebuilt as
a caller-given NamedTuple class, e.g. one of the JAX package's).  Values are
copied bit for bit; nothing here imports JAX.

For the LM: :func:`lm_params_from_jax` turns the JAX parameter tree (numpy
leaves, blocks stacked ``[L, ...]``) into the port's parameters;
:func:`caches_from_jax` / :func:`caches_to_jax` carry KV caches both ways,
and :func:`train_state_from_jax` / :func:`train_state_to_jax` a whole
training state (weights, Adam moments, counters);
:func:`random_lm_params` draws a parameter tree with numpy alone, so that
two machines (one with JAX, one with the card) build the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import engine, network_model, tuners, types

_PORT_TYPES = {cls.__name__: cls for cls in (
    types.NetParams, types.SLAParams, types.TransferParams, types.SimState,
    types.TunerState, types.TickMetrics, engine.ScanInputs,
    tuners.Measurement, network_model.NetOut)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(x, device=None):
    """numpy leaves (or a NamedTuple of them, nested) -> tensors on
    ``device`` (default: the CPU), in the port's NamedTuple classes."""
    if _is_namedtuple(x):
        cls = _PORT_TYPES.get(type(x).__name__, type(x))
        return cls(*[to_torch(v, device) for v in x])
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.array(x), device=device)


def to_numpy(x, like=None):
    """Tensors (or a NamedTuple of them, nested) -> numpy leaves.  ``like``
    names the NamedTuple class to rebuild the top level as (fields by
    position)."""
    if _is_namedtuple(x):
        vals = [to_numpy(v) for v in x]
        return (like or type(x))(*vals)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------------------ LM ---

def _tensor(a, device, dtype=None):
    """A numpy array (bfloat16 as ml_dtypes' type, read by its bits) as a
    tensor on ``device``, optionally cast to ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _f32_leaf(path) -> bool:
    """JAX keeps norm parameters in float32 under any model dtype."""
    return path[-1] in ("q_norm", "k_norm") or any(
        p in ("ln1", "ln2", "final_norm") for p in path)


def lm_params_from_jax(tree, cfg, device):
    """The JAX LM parameter tree (numpy leaves, blocks stacked [L, ...]) ->
    the port's parameters on ``device``: the same tree, each floating leaf
    in the dtype JAX's init gives it (norms float32, the rest the config's
    dtype), so a float32 tree from :func:`random_lm_params` serves either
    dtype."""
    wdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        return _tensor(node, device,
                       torch.float32 if _f32_leaf(path) else wdt)
    return conv(dict(tree), ())


def caches_from_jax(tree, device):
    """JAX stacked caches (``k``/``v`` [L, B, S, Hkv, hd], ``idx`` [L],
    ``prow`` marker for per-row caches) -> the port's cache dict."""
    return {"k": _tensor(tree["k"], device), "v": _tensor(tree["v"], device),
            "idx": int(np.asarray(tree["idx"]).reshape(-1)[0]),
            "per_row": "prow" in tree}


def _numpy(t):
    """A tensor as numpy (bfloat16 as ``ml_dtypes.bfloat16``, the type JAX
    reads)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def caches_to_jax(caches):
    """The port's cache dict -> JAX's stacked cache tree as numpy
    (bfloat16 leaves as ``ml_dtypes.bfloat16``, the type JAX reads)."""
    n_layers = caches["k"].shape[0]
    arr = _numpy
    out = {"k": arr(caches["k"]), "v": arr(caches["v"]),
           "idx": np.full((n_layers,), caches["idx"], np.int32)}
    if caches.get("per_row"):
        out["prow"] = np.zeros((n_layers,), np.int32)
    return out


def train_state_from_jax(state, cfg, device):
    """A JAX ``TrainState`` with numpy leaves (``params``, ``opt.mu``,
    ``opt.nu``, ``opt.count``, ``step``) -> the port's
    :class:`~repro_torch.train.TrainState` on ``device``.  Parameters take
    :func:`lm_params_from_jax`'s dtypes; moments and counters keep their
    own."""
    from .optim import OptState
    from .train import TrainState

    def same(tree):
        if isinstance(tree, dict):
            return {k: same(v) for k, v in tree.items()}
        return _tensor(tree, device)
    return TrainState(
        params=lm_params_from_jax(state.params, cfg, device),
        opt=OptState(mu=same(dict(state.opt.mu)), nu=same(dict(state.opt.nu)),
                     count=_tensor(state.opt.count, device)),
        step=_tensor(state.step, device))


def train_state_to_jax(state):
    """The port's ``TrainState`` -> ``{"params", "opt": {"mu", "nu",
    "count"}, "step"}`` of numpy leaves (bfloat16 as ``ml_dtypes``), the
    fields of JAX's ``TrainState`` / ``OptState`` by name."""
    def arr(tree):
        if isinstance(tree, dict):
            return {k: arr(v) for k, v in tree.items()}
        return _numpy(tree)
    return {"params": arr(state.params),
            "opt": {"mu": arr(state.opt.mu), "nu": arr(state.opt.nu),
                    "count": _numpy(state.opt.count)},
            "step": _numpy(state.step)}


def random_lm_params(cfg, seed: int = 0):
    """Random LM parameters in JAX's tree layout (blocks stacked [L, ...]),
    as float32 numpy, from ``np.random.default_rng(seed)`` alone.

    Scales are JAX's init (models/lm.py:63, layers.py:183-202, 435-451):
    ``embed`` normal * 0.02; attention weights normal / sqrt(d_model);
    ``wg``/``wu`` normal / sqrt(d_model), ``wd`` normal / sqrt(d_ff); biases
    0 and norm scales 1.  Draw order: embed, then per block leaf (wq, wk,
    wv, wo, wg, wu, wd) all L layers at once, then ``head`` if untied."""
    if cfg.moe is not None or cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError("random_lm_params covers the dense "
                                  "swiglu/geglu LMs")
    rng = np.random.default_rng(seed)
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    hd, h, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    def norm():
        if cfg.norm_type == "ln_nonparam":
            return {}
        out = {"scale": np.ones((L, d), np.float32)}
        if cfg.norm_type == "ln":
            out["bias"] = np.zeros((L, d), np.float32)
        return out

    s_d, s_ff = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    embed = normal((cfg.vocab_size, d), 0.02)
    attn = {"wq": normal((L, d, h * hd), s_d),
            "wk": normal((L, d, hkv * hd), s_d),
            "wv": normal((L, d, hkv * hd), s_d),
            "wo": normal((L, h * hd, d), s_d)}
    if cfg.qkv_bias:
        attn.update(bq=np.zeros((L, h * hd), np.float32),
                    bk=np.zeros((L, hkv * hd), np.float32),
                    bv=np.zeros((L, hkv * hd), np.float32))
    if cfg.qk_norm:
        attn.update(q_norm=np.ones((L, hd), np.float32),
                    k_norm=np.ones((L, hd), np.float32))
    mlp = {"wg": normal((L, d, ff), s_d), "wu": normal((L, d, ff), s_d),
           "wd": normal((L, ff, d), s_ff)}
    params = {"embed": embed,
              "blocks": {"ln1": norm(), "attn": attn, "ln2": norm(),
                         "mlp": mlp},
              "final_norm": {k: v[0] for k, v in norm().items()}}
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 0.02)
    return params
