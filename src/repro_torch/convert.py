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
leaves, blocks stacked ``[L, ...]``, or recurrentgemma's list of layers)
into the port's parameters;
:func:`caches_from_jax` / :func:`caches_to_jax` carry KV caches both ways,
:func:`states_from_jax` / :func:`states_to_jax` the recurrent families'
decode states,
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


#: Leaves JAX's init keeps in float32 under any model dtype: qk-norm
#: scales, the MoE router, rwkv6's mixing, decay, bonus and GroupNorm
#: parameters, and the RG-LRU's Λ; and everything under a norm (whisper's
#: included).
_F32_LEAVES = ("q_norm", "k_norm", "router", "mu", "w0", "u", "gn_scale",
               "mu_k", "mu_r", "lam")
_F32_NORMS = ("ln0", "ln1", "ln2", "ln_x", "ln_out", "final_norm",
              "enc_norm", "dec_norm")


def _f32_leaf(path) -> bool:
    return path[-1] in _F32_LEAVES or any(p in _F32_NORMS for p in path)


def lm_params_from_jax(tree, cfg, device):
    """The JAX LM parameter tree (numpy leaves; blocks stacked [L, ...], or
    a list of per-layer dicts) -> the port's parameters on ``device``: the
    same tree, each floating leaf in the dtype JAX's init gives it
    (:data:`_F32_LEAVES` and norms float32, the rest the config's dtype),
    so a float32 tree from :func:`random_lm_params` serves either dtype."""
    wdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, path + (str(i),)) for i, v in enumerate(node)]
        return _tensor(node, device,
                       torch.float32 if _f32_leaf(path) else wdt)
    return conv(dict(tree), ())


def caches_from_jax(tree, device):
    """JAX stacked caches (``k``/``v`` [L, B, S, Hkv, hd], ``idx`` [L],
    ``prow`` marker for per-row caches) -> the port's cache dict; or
    whisper's list of per-layer caches -> a list of the port's."""
    if isinstance(tree, (list, tuple)):
        return [caches_from_jax(c, device) for c in tree]
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
    (bfloat16 leaves as ``ml_dtypes.bfloat16``, the type JAX reads); a
    list of per-layer caches (whisper's) -> JAX's list, each ``idx`` a
    scalar."""
    if isinstance(caches, list):
        return [{"k": _numpy(c["k"]), "v": _numpy(c["v"]),
                 "idx": np.int32(c["idx"])} for c in caches]
    n_layers = caches["k"].shape[0]
    arr = _numpy
    out = {"k": arr(caches["k"]), "v": arr(caches["v"]),
           "idx": np.full((n_layers,), caches["idx"], np.int32)}
    if caches.get("per_row"):
        out["prow"] = np.zeros((n_layers,), np.int32)
    return out


def states_from_jax(states, device):
    """A recurrent family's JAX decode state (numpy leaves) -> the port's:
    rwkv6's stacked triple (tm_last, S, cm_last), or recurrentgemma's list
    of per-layer ring caches (dicts with ``k``, ``v``, ``pos``, ``idx``)
    and (conv_state, h) pairs.  Dtypes are kept."""
    def ring(c):
        return {"k": _tensor(c["k"], device), "v": _tensor(c["v"], device),
                "pos": _tensor(c["pos"], device),
                "idx": int(np.asarray(c["idx"])), "per_row": False}
    if isinstance(states, tuple):
        return tuple(_tensor(x, device) for x in states)
    return [ring(st) if isinstance(st, dict) else
            tuple(_tensor(x, device) for x in st) for st in states]


def states_to_jax(states):
    """The port's decode state of a recurrent family -> JAX's, as numpy
    (bfloat16 leaves as ``ml_dtypes.bfloat16``): the inverse of
    :func:`states_from_jax`."""
    def ring(c):
        return {"k": _numpy(c["k"]), "v": _numpy(c["v"]),
                "pos": _numpy(c["pos"]), "idx": np.int32(c["idx"])}
    if isinstance(states, tuple):
        return tuple(_numpy(x) for x in states)
    return [ring(st) if isinstance(st, dict) else
            tuple(_numpy(x) for x in st) for st in states]


def train_state_from_jax(state, cfg, device):
    """A JAX ``TrainState`` with numpy leaves (``params``, ``opt.mu``,
    ``opt.nu``, ``opt.count``, ``step``; blocks stacked, or recurrentgemma's
    list of layers) -> the port's
    :class:`~repro_torch.train.TrainState` on ``device``.  Parameters take
    :func:`lm_params_from_jax`'s dtypes; moments and counters keep their
    own."""
    from .optim import OptState
    from .train import TrainState

    def same(tree):
        if isinstance(tree, dict):
            return {k: same(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [same(v) for v in tree]
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
        if isinstance(tree, list):
            return [arr(v) for v in tree]
        return _numpy(tree)
    return {"params": arr(state.params),
            "opt": {"mu": arr(state.opt.mu), "nu": arr(state.opt.nu),
                    "count": _numpy(state.opt.count)},
            "step": _numpy(state.step)}


def random_lm_params(cfg, seed: int = 0):
    """Random LM parameters in JAX's tree layout, as float32 numpy, from
    ``np.random.default_rng(seed)`` alone, for every family.

    Decoder-only LMs (dense, MoE, VLM; blocks stacked [L, ...]).  Scales
    are JAX's init (models/lm.py:63, layers.py:183-202, 435-451, 464-480):
    ``embed`` normal * 0.02; attention weights normal / sqrt(d_model);
    ``wg``/``wu`` normal / sqrt(d_model), ``wd`` normal / sqrt(d_ff); the
    MoE's ``router`` normal / sqrt(d_model) (float32 in every dtype), its
    experts [L, E, ...] as the MLP's at ``d_ff_expert``, and its shared
    experts one MLP of ``num_shared_experts x d_ff_expert``; biases 0 and
    norm scales 1.  Draw order: embed, then per block leaf (wq, wk, wv, wo,
    then wg, wu, wd or router, wg, wu, wd and the shared wg, wu, wd) all L
    layers at once, then ``head`` if untied.  The other families:
    :func:`_random_rwkv6`, :func:`_random_rglru`, :func:`_random_whisper`."""
    if cfg.family == "ssm":
        return _random_rwkv6(cfg, np.random.default_rng(seed))
    if cfg.family == "hybrid":
        return _random_rglru(cfg, np.random.default_rng(seed))
    if cfg.family == "audio":
        return _random_whisper(cfg, np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    L, d = cfg.num_layers, cfg.d_model

    def norm():
        if cfg.norm_type == "ln_nonparam":
            return {}
        out = {"scale": np.ones((L, d), np.float32)}
        if cfg.norm_type == "ln":
            out["bias"] = np.zeros((L, d), np.float32)
        return out

    embed = _normal(rng, (cfg.vocab_size, d), 0.02)
    blocks = {"ln1": norm(), "attn": _random_attention(cfg, rng, (L,)),
              "ln2": norm()}
    if cfg.moe is not None:
        m = cfg.moe
        E, ff = m.num_experts, m.d_ff_expert
        moe = {"router": _normal(rng, (L, d, E), 1.0 / np.sqrt(d)),
               **_random_swiglu(rng, (L, E), d, ff)}
        if m.num_shared_experts:
            moe["shared"] = _random_swiglu(rng, (L,), d,
                                           ff * m.num_shared_experts)
        blocks["moe"] = moe
    elif cfg.mlp_type in ("swiglu", "geglu"):
        blocks["mlp"] = _random_swiglu(rng, (L,), d, cfg.d_ff)
    else:
        raise ValueError(f"a decoder-only LM with mlp_type "
                         f"{cfg.mlp_type!r} has no JAX init")
    params = {"embed": embed, "blocks": blocks,
              "final_norm": {k: v[0] for k, v in norm().items()}}
    if not cfg.tie_embeddings:
        params["head"] = _normal(rng, (d, cfg.vocab_size), 0.02)
    return params


def _random_attention(cfg, rng, lead=(), cross=False):
    """Attention weights [*lead, ...] (layers.py:183-202): wq, wk, wv, wo
    drawn in that order; biases 0 (none for ``cross``), qk-norm scales 1."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    s_d = 1.0 / np.sqrt(d)
    p = {"wq": _normal(rng, lead + (d, h * hd), s_d),
         "wk": _normal(rng, lead + (d, hkv * hd), s_d),
         "wv": _normal(rng, lead + (d, hkv * hd), s_d),
         "wo": _normal(rng, lead + (h * hd, d), s_d)}
    if cfg.qkv_bias and not cross:
        p.update(bq=np.zeros(lead + (h * hd,), np.float32),
                 bk=np.zeros(lead + (hkv * hd,), np.float32),
                 bv=np.zeros(lead + (hkv * hd,), np.float32))
    if cfg.qk_norm:
        p.update(q_norm=np.ones(lead + (hd,), np.float32),
                 k_norm=np.ones(lead + (hd,), np.float32))
    return p


def _random_swiglu(rng, lead, d, ff):
    """A SwiGLU MLP's wg, wu, wd [*lead, ...], drawn in that order."""
    return {"wg": _normal(rng, lead + (d, ff), 1.0 / np.sqrt(d)),
            "wu": _normal(rng, lead + (d, ff), 1.0 / np.sqrt(d)),
            "wd": _normal(rng, lead + (ff, d), 1.0 / np.sqrt(ff))}


def _random_whisper(cfg, rng):
    """whisper (models/whisper.py:34-63 in JAX), lists of per-layer dicts:
    ``embed`` [padded vocab, D] normal * 0.02; attention as
    :func:`_random_attention` (the cross-attention without biases); the
    GELU MLP's ``wu`` normal / sqrt(d_model), ``wd`` normal / sqrt(d_ff),
    biases 0; LayerNorm scales 1, biases 0.  Draw order: embed; then layer
    by layer the encoder's (attention, wu, wd), then the decoder's
    (self-attention, cross-attention, wu, wd)."""
    d, ff = cfg.d_model, cfg.d_ff
    pv = ((cfg.vocab_size + 15) // 16) * 16          # whisper.padded_vocab

    def ln():
        return {"scale": np.ones((d,), np.float32),
                "bias": np.zeros((d,), np.float32)}

    def gelu_mlp():
        return {"wu": _normal(rng, (d, ff), 1.0 / np.sqrt(d)),
                "bu": np.zeros((ff,), np.float32),
                "wd": _normal(rng, (ff, d), 1.0 / np.sqrt(ff)),
                "bd": np.zeros((d,), np.float32)}
    embed = _normal(rng, (pv, d), 0.02)
    enc = [{"ln1": ln(), "attn": _random_attention(cfg, rng), "ln2": ln(),
            "mlp": gelu_mlp()} for _ in range(cfg.num_encoder_layers)]
    dec = []
    for _ in range(cfg.num_layers):
        self_attn = _random_attention(cfg, rng)
        cross_attn = _random_attention(cfg, rng, cross=True)
        dec.append({"ln1": ln(), "self_attn": self_attn, "ln_x": ln(),
                    "cross_attn": cross_attn, "ln2": ln(),
                    "mlp": gelu_mlp()})
    return {"embed": embed, "enc_layers": enc, "enc_norm": ln(),
            "dec_layers": dec, "dec_norm": ln()}


def _normal(rng, shape, scale):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _random_rwkv6(cfg, rng):
    """rwkv6 (models/rwkv6.py:31-82 in JAX), blocks stacked [L, ...]:
    ``embed`` and ``head`` normal * 0.02; ``mix_A``, ``w_A`` and the time
    mix's ``wr``/``wk``/``wv``/``wg``/``wo`` normal / sqrt(d_model);
    ``mix_B``, ``w_B`` normal * 0.01; the channel mix's ``wk``, ``wr``
    normal / sqrt(d_model) and ``wv`` normal / sqrt(d_ff); ``mu``, ``u``,
    ``mu_k``, ``mu_r`` 0.5, ``w0`` -6, GroupNorm and LayerNorm scales 1 and
    biases 0.  Draw order: embed; then, all L layers at once, the time
    mix's mix_A, mix_B, w_A, w_B, wr, wk, wv, wg, wo and the channel mix's
    wk, wv, wr; then head."""
    L, d, ff, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    s_d = 1.0 / np.sqrt(d)

    def full(shape, value):
        return np.full(shape, value, np.float32)

    def ln(lead=()):
        return {"scale": np.ones(lead + (d,), np.float32),
                "bias": np.zeros(lead + (d,), np.float32)}

    embed = _normal(rng, (V, d), 0.02)
    tm = {"mix_A": _normal(rng, (L, 5, d, 32), s_d),
          "mix_B": _normal(rng, (L, 5, 32, d), 0.01),
          "w_A": _normal(rng, (L, d, 64), s_d),
          "w_B": _normal(rng, (L, 64, d), 0.01)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        tm[name] = _normal(rng, (L, d, d), s_d)
    tm.update(mu=full((L, 5, d), 0.5), w0=full((L, d), -6.0),
              u=full((L, d), 0.5), gn_scale=full((L, d), 1.0))
    cm = {"wk": _normal(rng, (L, d, ff), s_d),
          "wv": _normal(rng, (L, ff, d), 1.0 / np.sqrt(ff)),
          "wr": _normal(rng, (L, d, d), s_d),
          "mu_k": full((L, d), 0.5), "mu_r": full((L, d), 0.5)}
    return {"embed": embed, "ln0": ln(),
            "blocks": {"ln1": ln((L,)), "tm": tm, "ln2": ln((L,)),
                       "cm": cm},
            "ln_out": ln(), "head": _normal(rng, (d, V), 0.02)}


def _random_rglru(cfg, rng):
    """recurrentgemma (models/rglru.py:53-140 and layers.py:183-202,
    435-451 in JAX), a list of per-layer dicts: ``embed`` normal * 0.02;
    attention and ``wx``/``wy`` normal / sqrt(d_model); ``conv_w`` normal *
    0.1; the gates' blocks normal / sqrt(lru / 8); ``wo`` normal /
    sqrt(lru); GeGLU ``wg``/``wu`` normal / sqrt(d_model), ``wd`` normal /
    sqrt(d_ff); biases 0, RMSNorm scales 1, ``lam`` linspace(2.2, 6.9).
    Draw order: embed; then layer by layer its attention (wq, wk, wv, wo)
    or recurrent block (wx, wy, conv_w, gate_a, gate_x, wo), then its MLP
    (wg, wu, wd)."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    lru = cfg.lru_width or d
    bd = lru // 8
    s_d = 1.0 / np.sqrt(d)
    embed = _normal(rng, (V, d), 0.02)
    layers = []
    for i in range(cfg.num_layers):
        p = {"ln1": {"scale": np.ones((d,), np.float32)},
             "ln2": {"scale": np.ones((d,), np.float32)}}
        if cfg.block_pattern[i % len(cfg.block_pattern)] == "local":
            p["attn"] = _random_attention(cfg, rng)
        else:
            p["rec"] = {
                "wx": _normal(rng, (d, lru), s_d),
                "wy": _normal(rng, (d, lru), s_d),
                "conv_w": _normal(rng, (cfg.conv_width, lru), 0.1),
                "conv_b": np.zeros((lru,), np.float32),
                "gate_a": {"w": _normal(rng, (8, bd, bd), 1 / np.sqrt(bd)),
                           "b": np.zeros((lru,), np.float32)},
                "gate_x": {"w": _normal(rng, (8, bd, bd), 1 / np.sqrt(bd)),
                           "b": np.zeros((lru,), np.float32)},
                "lam": np.linspace(2.2, 6.9, lru).astype(np.float32),
                "wo": _normal(rng, (lru, d), 1.0 / np.sqrt(lru))}
        p["mlp"] = _random_swiglu(rng, (), d, ff)
        layers.append(p)
    return {"embed": embed, "layers": layers,
            "final_norm": {"scale": np.ones((d,), np.float32)}}
