"""Abstract inputs and their layout for every (arch x shape) cell (the port
of ``repro/launch/input_specs.py``).

An input is a ``meta`` tensor (JAX's ``ShapeDtypeStruct``): its shape and
type, nothing allocated.  Its layout is a :class:`NamedSharding`, JAX's
name: the mesh, the PartitionSpec :class:`~repro_torch.distributed.
sharding.P` and the DTensor placements ``sharding.shardings`` gives it.
The mesh is a ``DeviceMesh`` or an ``AbstractMesh`` (``sharding.
mesh_shape`` reads either).  A decode state is the bundle's own
``init_decode_state`` on ``meta``, and its specs follow the port's state
tree leaf for leaf: a cache's write offset ``idx`` is a host int there
(JAX: an int32 array), it gets JAX's spec, and the port's ``per_row`` flag
gets none.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import SHAPES, get_config
from ..distributed.sharding import P, data_axes, mesh_shape, shardings
from ..models import build
from ..models.common import ModelConfig

VLM_IMG_TOKENS = 1024   # patch-token slots inside the sequence (stub frontend)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """An input's layout: its spec on ``mesh`` and the DTensor placements
    of that spec (one per mesh dim)."""

    mesh: object
    spec: P
    placements: tuple


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_axes(mesh, batch: int, dp_only: bool = False):
    """Largest prefix of the dp axes that divides ``batch``.  With
    ``dp_only`` the 'model' axis joins the batch axes (pure data
    parallelism)."""
    shape = mesh_shape(mesh)
    axes = []
    n = 1
    cand = data_axes(mesh) + (("model",) if dp_only else ())
    for ax in cand:
        size = shape[ax]
        if batch % (n * size) == 0:
            axes.append(ax)
            n *= size
    return tuple(axes) if axes else None


def kv_cache_spec(cfg: ModelConfig, mesh, batch_axes, stacked: bool):
    """KV cache [.., B, S, Hkv, hd]: heads over 'model' when it divides
    them, else the sequence."""
    msize = mesh_shape(mesh)["model"]
    if cfg.num_kv_heads % msize == 0:
        spec = P(batch_axes, None, "model", None)
    else:
        spec = P(batch_axes, "model", None, None)
    return P(None, *spec) if stacked else spec


def _cache_specs(kv, idx_spec):
    """A cache dict's specs: k, v by ``kv``, idx by ``idx_spec``, per_row
    none."""
    return {"k": kv, "v": kv, "idx": idx_spec, "per_row": None}


def _state_specs(cfg: ModelConfig, mesh, state, batch: int):
    """Specs for a decode state (family-dependent), shaped like ``state``."""
    ba = _batch_axes(mesh, batch)

    if cfg.family in ("dense", "moe", "vlm"):
        # one stacked cache: k/v [L, B, S, Hkv, hd], idx (JAX: [L])
        return _cache_specs(kv_cache_spec(cfg, mesh, ba, stacked=True),
                            P(None))
    if cfg.family == "ssm":
        # (tm_last [L,B,D], S [L,B,H,hd,hd], cm_last [L,B,D])
        msize = mesh_shape(mesh)["model"]
        hspec = "model" if cfg.num_heads % msize == 0 else None
        return (P(None, ba, "model"),
                P(None, ba, hspec, None, None),
                P(None, ba, "model"))
    if cfg.family == "hybrid":
        specs = []
        for st in state:
            if isinstance(st, dict):          # ring kv cache
                kv = kv_cache_spec(cfg, mesh, ba, stacked=False)
                specs.append(dict(_cache_specs(kv, P()), pos=P(ba, None)))
            else:                             # (conv_state, h)
                specs.append((P(ba, None, "model"), P(ba, "model")))
        return specs
    if cfg.family == "audio":
        kv = kv_cache_spec(cfg, mesh, ba, stacked=False)
        return [_cache_specs(kv, P()) for _ in state]
    raise ValueError(cfg.family)


def _shard_tree(mesh, specs):
    """Each spec of the tree as a :class:`NamedSharding` (None stays)."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs, shardings(mesh, specs))
    if isinstance(specs, dict):
        return {k: _shard_tree(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (tuple, list)):
        return type(specs)(_shard_tree(mesh, v) for v in specs)
    return specs


def input_specs(cfg, shape_name: str, mesh, dp_only: bool = False):
    """Returns (abstract_inputs: dict of meta tensors, input_shardings:
    dict of :class:`NamedSharding` trees, kind).

    ``cfg``: a ModelConfig (possibly a depth-reduced probe variant) or an
    arch name."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    sh = SHAPES[shape_name]
    kind, S, B = sh["kind"], sh["seq_len"], sh["global_batch"]
    ba = _batch_axes(mesh, B, dp_only)
    tok_spec = P(ba, None)
    dt = torch.bfloat16

    if kind in ("train", "prefill"):
        inputs = {"tokens": _meta((B, S), torch.int32)}
        specs = {"tokens": tok_spec}
        if kind == "train":
            inputs["labels"] = _meta((B, S), torch.int32)
            specs["labels"] = tok_spec
        if cfg.family == "audio":
            inputs["frame_embeds"] = _meta((B, cfg.encoder_positions,
                                            cfg.d_model), dt)
            specs["frame_embeds"] = P(ba, None, "model")
        if cfg.family == "vlm":
            inputs["vision_embeds"] = _meta((B, VLM_IMG_TOKENS, cfg.d_model),
                                            dt)
            inputs["mrope_pos"] = _meta((3, B, S), torch.int32)
            specs["vision_embeds"] = P(ba, None, "model")
            specs["mrope_pos"] = P(None, ba, None)
        return inputs, _shard_tree(mesh, specs), kind

    # decode: one new token against a length-S state
    state = build(cfg).init_decode_state(B, S, device="meta")
    inputs = {"tokens": _meta((B, 1), torch.int32),
              "positions": _meta((B, 1), torch.int32),
              "state": state}
    specs = {"tokens": tok_spec, "positions": tok_spec,
             "state": _state_specs(cfg, mesh, state, B)}
    if cfg.family == "audio":
        inputs["enc_out"] = _meta((B, cfg.encoder_positions, cfg.d_model), dt)
        specs["enc_out"] = P(ba, None, "model")
    if cfg.family == "vlm":
        inputs["mrope_pos"] = _meta((3, B, 1), torch.int32)
        specs["mrope_pos"] = P(None, ba, None)
    return inputs, _shard_tree(mesh, specs), kind
