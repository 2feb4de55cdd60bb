"""Partition rules, meshes and lane-batch helpers (the port of
``repro/distributed/sharding.py``).

Two jobs live here, as in the JAX module:

1. The model stack's partitioning over a mesh (a
   ``torch.distributed.device_mesh.DeviceMesh`` from
   ``repro_torch.launch.mesh``): every parameter path maps to a
   PartitionSpec :class:`P` (``spec_for``, ``param_specs``, ``batch_spec``,
   ``zero_specs``); :func:`shardings` turns specs into DTensor placements
   and :func:`place` places a tensor by them; :func:`set_mesh` holds the
   ambient mesh that :func:`get_abstract_mesh` reads; :func:`shard_map`
   runs a function on each rank's local blocks.

   Arrays are global, as JAX's: every rank holds the whole value of a
   tensor it passes to :func:`shard_map` (a DTensor leaf of a placed tree
   is gathered with :func:`gather_full` first), ``shard_map`` cuts out the
   rank's block by the input specs and, after ``f``, reassembles the
   outputs by theirs (an all-gather of the blocks), so every rank gets
   the same result.  The cut and the reassembly are autograd functions whose
   backwards are JAX's shard_map transposes: an input's gradient is
   summed over the ranks that shared its block; a replicated output's
   cotangent is divided among its replicas.  A collective over a tuple of
   axes (JAX's ``("pod", "data")``) runs on a process group spanning those
   mesh dims (:func:`axis_group`, made once per mesh and tuple).

2. Lane-batch sharding for the transfer engine and the fleets: a 1-D lane
   mesh is the tuple of torch devices itself and a sharded batch is one
   contiguous slice of the lane axis per device, each moved to its device
   (``batch_mesh``, ``pad_batch``, ``split_batch``, ``shard_batch``,
   ``MeshConfig``): lanes are independent, so the devices run their slices
   with no communication, and the caller concatenates the results in
   device order.  Batches are trees of arrays with a leading lane axis:
   tuples, lists, NamedTuples or dicts of numpy arrays (or tensors).

Mesh axes:
    single pod:  (data=16, model=16)
    multi-pod:   (pod=2, data=16, model=16) -- batch shards over (pod, data)

Tensor-parallel scheme (megatron-style), JAX's rules:
    embed   [V, D]          -> (model, None)
    wq/wk/wv [D, H*hd]      -> (None, model)
    wo      [H*hd, D]       -> (model, None)
    mlp wg/wu [D, F]        -> (None, model);  wd [F, D] -> (model, None)
    MoE experts [E, D, F]   -> (model, None, None)  expert-parallel
    rwkv / rglru projections column/row like attention; small leaves and
    1-D params (norms, mus) replicated.
Stacked-layer params carry a leading L axis -> prepend None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of tuples, lists, NamedTuples and
    dicts (and the matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def local_devices() -> tuple:
    """The CUDA devices this process sees; raises without a card (nothing
    moves to the CPU by itself: pass CPU devices explicitly)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass the devices "
                           "explicitly (e.g. (torch.device('cpu'),))")
    return tuple(torch.device("cuda", i) for i in range(n))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The lane-batch mesh of a fleet as ``num_hosts`` processes of
    ``devices_per_host`` cards each, flattened into one tuple of devices.

    ``devices_per_host=None`` means every visible card (one host).
    :meth:`devices` validates the request against the cards the process
    sees: asking for more raises rather than running on fewer.
    """

    num_hosts: int = 1
    devices_per_host: Optional[int] = None

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if self.devices_per_host is not None and self.devices_per_host < 1:
            raise ValueError(f"devices_per_host must be >= 1, got "
                             f"{self.devices_per_host}")

    @property
    def mesh_size(self) -> Optional[int]:
        if self.devices_per_host is None:
            return None
        return self.num_hosts * self.devices_per_host

    def devices(self) -> tuple:
        """The flattened (hosts x devices_per_host) device tuple, validated
        against :func:`local_devices`."""
        avail = local_devices()
        want = self.mesh_size
        if want is None:
            return avail
        if want > len(avail):
            raise ValueError(
                f"MeshConfig wants {self.num_hosts} hosts x "
                f"{self.devices_per_host} devices = {want}, but only "
                f"{len(avail)} devices are visible")
        return avail[:want]

    def mesh(self) -> tuple:
        """The 1-D mesh over :meth:`devices`."""
        return batch_mesh(self.devices())


def batch_mesh(devices=None) -> tuple:
    """The 1-D lane mesh: a tuple of torch devices (default: every visible
    card)."""
    devices = local_devices() if devices is None else devices
    return tuple(torch.device(d) for d in devices)


def pad_batch(tree, multiple: int, *, fill: str = "repeat"):
    """Pad axis 0 of every leaf up to a multiple of ``multiple``.

    Returns ``(padded_tree, original_batch_size)``; callers slice results
    back to the original size.  ``fill`` selects the padding rows:

    * ``"repeat"`` (default) repeats the last row.
    * ``"zero"`` appends zero rows — what the fleet wants: a zeroed engine
      lane has no bytes remaining, so it is born drained and frozen from
      its first tick, costing nothing.
    """
    if fill not in ("repeat", "zero"):
        raise ValueError(f"unknown fill mode {fill!r}")
    sizes = {np.shape(leaf)[0] for leaf in _leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes in tree: {sizes}")
    b = sizes.pop()
    pad = (-b) % multiple
    if pad == 0:
        return tree, b
    if fill == "zero":
        return _map(
            lambda x: np.concatenate(
                [x, np.zeros((pad,) + np.shape(x)[1:], np.asarray(x).dtype)]),
            tree), b
    return _map(
        lambda x: np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]),
        tree), b


def split_batch(tree, n: int) -> list:
    """``n`` trees of equal contiguous slices of axis 0 (which ``n`` must
    divide: pad with :func:`pad_batch` first)."""
    b = np.shape(_leaves(tree)[0])[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split over {n} devices; "
                         f"pad it with pad_batch first")
    k = b // n
    return [_map(lambda x, i=i: x[i * k:(i + 1) * k], tree) for i in range(n)]


def shard_batch(tree, mesh: tuple) -> list:
    """Place a lane batch on ``mesh``: one contiguous slice of axis 0 per
    device, as tensors on that device."""
    return [_map(lambda x, d=d: torch.as_tensor(x).to(d), part)
            for d, part in zip(mesh, split_batch(tree, len(mesh)))]


# ------------------------------------------------------------ the mesh ---

class P(tuple):
    """A PartitionSpec: one entry per array dim, each None (not sharded),
    a mesh axis name, or a tuple of names (sharded over their product,
    the first the major).  A tuple of one name is that name and an empty
    one None, as JAX normalises them."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            (None if not a else a[0] if len(a) == 1 else a)
            if isinstance(a, tuple) else a for a in axes))

    def __reduce__(self):
        return P, tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """What :func:`get_abstract_mesh` returns: the ambient DeviceMesh (or
    none) with JAX's queries ``empty``, ``shape`` (axis name -> size) and
    ``axis_names``."""

    device_mesh: Optional[object] = None

    @property
    def empty(self) -> bool:
        return self.device_mesh is None

    @property
    def axis_names(self) -> tuple:
        return () if self.empty else tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        return mesh_shape(self.device_mesh)


def _device_mesh(mesh):
    return mesh.device_mesh if isinstance(mesh, AbstractMesh) else mesh


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an :class:`AbstractMesh`."""
    dm = _device_mesh(mesh)
    if dm is None:
        return {}
    return dict(zip(dm.mesh_dim_names, dm.mesh.shape))


_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Hold ``mesh`` (a DeviceMesh) as the ambient mesh while entered."""
    _AMBIENT.append(_device_mesh(mesh))
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_abstract_mesh() -> AbstractMesh:
    """The ambient mesh, or an empty one outside :func:`set_mesh`."""
    return AbstractMesh(_AMBIENT[-1] if _AMBIENT else None)


def _axes_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_group(mesh, axes):
    """The process group of this rank over the mesh axes ``axes`` (a name
    or a tuple of names, JAX's ``axis_name``), its ranks in row-major
    order of those axes.  A single axis is the DeviceMesh's own group;
    a tuple is made once per mesh (kept on it) with ``new_group`` on every
    rank (every rank must ask for the same tuples in the same order, as it
    does running the same program)."""
    dm = _device_mesh(mesh)
    axes = _axes_tuple(axes)
    if len(axes) == 1:
        return dm.get_group(axes[0])
    if not hasattr(dm, "_repro_axis_groups"):
        dm._repro_axis_groups = {}
    groups = dm._repro_axis_groups
    if axes not in groups:
        names = list(dm.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        n = math.prod(dm.mesh.shape[i] for i in dims)
        rows = dm.mesh.permute(*rest, *dims).reshape(-1, n).tolist()
        me = dist.get_rank()
        mine = None
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                mine = g
        groups[axes] = mine
    return groups[axes]


def axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes_tuple(axes))


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major, the first the major;
    JAX's ``lax.axis_index``)."""
    dm = _device_mesh(mesh)
    coord = dict(zip(dm.mesh_dim_names, dm.get_coordinate()))
    shape = mesh_shape(dm)
    idx = 0
    for a in _axes_tuple(axes):
        idx = idx * shape[a] + coord[a]
    return idx


def local_block(x, mesh, spec):
    """This rank's block of the global ``x`` by ``spec``."""
    for dim, axes in enumerate(tuple(spec)):
        n = axis_size(mesh, axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks of {_axes_tuple(axes)}")
        k = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axes) * k, k)
    return x


def _unmentioned(mesh, spec) -> tuple:
    used = {a for axes in tuple(spec) for a in _axes_tuple(axes)}
    return tuple(a for a in mesh_shape(mesh) if a not in used)


def _mentioned(spec) -> tuple:
    return tuple(a for axes in tuple(spec) for a in _axes_tuple(axes))


def _gather_global(y, shape, mesh, spec):
    """The global value (``shape``) whose block by ``spec`` each rank holds
    in ``y``: an all-gather over the spec's axes, each block put at its
    ranks' coordinates.  Ranks that differ only in the other axes gather
    alike."""
    axes = _mentioned(spec)
    if axis_size(mesh, axes) == 1:
        return y
    dm = _device_mesh(mesh)
    group = axis_group(dm, axes)
    members = dist.get_process_group_ranks(group)
    buf = y.new_empty((len(members) * y.shape[0],) + tuple(y.shape[1:]))
    dist.all_gather_into_tensor(buf, y.contiguous(), group=group)
    buf = buf.view((len(members),) + tuple(y.shape))
    names = list(dm.mesh_dim_names)
    shape_of = mesh_shape(dm)
    full = y.new_empty(shape)
    for j, r in enumerate(members):
        coord = (dm.mesh == r).nonzero()[0].tolist()
        block = full
        for dim, ax in enumerate(tuple(spec)):
            ax = _axes_tuple(ax)
            idx = 0
            for a in ax:
                idx = idx * shape_of[a] + coord[names.index(a)]
            k = y.shape[dim]
            block = block.narrow(dim, idx * k, k)
        block.copy_(buf[j])
    return full


class _Cut(torch.autograd.Function):
    """The rank's block of a global input; its gradient is summed over the
    ranks that share the block (an all-reduce over the axes ``spec`` does
    not name) and the blocks gathered (over the axes it does), so every
    rank gets the global gradient."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.shape = mesh, spec, x.shape
        return local_block(x, mesh, spec).clone()

    @staticmethod
    def backward(ctx, g):
        rep = _unmentioned(ctx.mesh, ctx.spec)
        if axis_size(ctx.mesh, rep) > 1:
            g = g.contiguous()
            dist.all_reduce(g, group=axis_group(ctx.mesh, rep))
        return _gather_global(g, ctx.shape, ctx.mesh, ctx.spec), None, None


class _Assemble(torch.autograd.Function):
    """The global output gathered from each rank's block (a ``P()`` output
    is the rank's own value, equal on every rank by shard_map's contract);
    the cotangent of a block is divided among its replicas (JAX's
    transpose of an unmapped output)."""

    @staticmethod
    def forward(ctx, y, mesh, spec, shape):
        ctx.mesh, ctx.spec = mesh, spec
        ctx.n_rep = axis_size(mesh, _unmentioned(mesh, spec))
        full = _gather_global(y, shape, mesh, spec)
        return y.clone() if full is y else full

    @staticmethod
    def backward(ctx, g):
        g = local_block(g, ctx.mesh, ctx.spec)
        if ctx.n_rep != 1:
            g = g / ctx.n_rep
        return g.contiguous(), None, None, None


_SHARD_MESH: list = []


def current_shard_mesh():
    """The mesh of the :func:`shard_map` body running now (JAX's bound
    axis names); raises outside one."""
    if not _SHARD_MESH:
        raise NameError("a collective over a mesh axis runs inside "
                        "shard_map only (unbound axis name)")
    return _SHARD_MESH[-1]


def _spec_leaves(specs, args):
    """JAX's prefix rule: one spec for every arg, or one per arg."""
    if isinstance(specs, P):
        return [specs] * len(args)
    specs = list(specs)
    if len(specs) != len(args):
        raise ValueError(f"{len(specs)} specs for {len(args)} values")
    return specs


def shard_map(f, *, mesh, in_specs, out_specs):
    """``f`` on each rank's local blocks of the global inputs (cut by
    ``in_specs``), its outputs reassembled into global values by
    ``out_specs`` (a ``P()`` output is taken as equal on every rank).
    Collectives inside ``f`` (``psum``, ``pmean``, ``all_to_all``,
    :func:`~repro_torch.distributed.collectives.chunked_psum`) name mesh
    axes.  On a mesh of one rank the blocks are the inputs themselves."""
    dm = _device_mesh(mesh)

    def run(*args):
        size = dm.mesh.numel()
        if size > 1:
            args = [_Cut.apply(x, dm, s) if isinstance(x, torch.Tensor)
                    else x for x, s in zip(args, _spec_leaves(in_specs,
                                                              args))]
        _SHARD_MESH.append(dm)
        try:
            out = f(*args)
        finally:
            _SHARD_MESH.pop()
        if size == 1:
            return out
        single = isinstance(out_specs, P)
        outs = (out,) if single else tuple(out)
        specs = _spec_leaves(out_specs, outs)
        glob = []
        for y, s in zip(outs, specs):
            shape = list(y.shape)
            for dim, axes in enumerate(tuple(s)):
                shape[dim] *= axis_size(dm, axes)
            glob.append(_Assemble.apply(y, dm, s, shape))
        return glob[0] if single else tuple(glob)

    return run


@contextlib.contextmanager
def _autograd_collectives():
    """``torch.distributed.nn.functional`` (the public autograd-aware
    collectives, deprecated in favour of a private module), its
    deprecation warnings silenced while entered."""
    import warnings

    import torch.distributed.nn.functional as dfn

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield dfn


def psum(x, axes):
    """Sum over the mesh axes ``axes`` inside :func:`shard_map`
    (autograd-aware: the gradient is summed too)."""
    with _autograd_collectives() as dfn:
        return dfn.all_reduce(x, group=axis_group(current_shard_mesh(),
                                                  axes))


def pmean(x, axes):
    """Mean over the mesh axes ``axes`` inside :func:`shard_map`."""
    n = axis_size(current_shard_mesh(), axes)
    return torch.div(psum(x, axes), n)


def all_to_all(x, axis, split_axis, concat_axis):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    inside :func:`shard_map`: ``x``'s ``split_axis`` is cut in the axis's
    size of equal parts, part j goes to the axis's rank j, and the parts
    received are concatenated along ``concat_axis`` in source order.
    Autograd-aware (``torch.distributed.nn.functional.all_to_all_single``
    sends the gradients back)."""
    dm = current_shard_mesh()
    n = axis_size(dm, axis)
    shape = list(x.shape)
    parts = x.reshape(shape[:split_axis] + [n, shape[split_axis] // n]
                      + shape[split_axis + 1:]).movedim(split_axis, 0)
    send = parts.contiguous()
    with _autograd_collectives() as dfn:
        recv = dfn.all_to_all_single(torch.empty_like(send), send,
                                     group=axis_group(dm, axis))
    # recv [n (source), ...the part...]: concatenate along concat_axis
    recv = recv.movedim(0, concat_axis)
    out_shape = list(recv.shape)
    del out_shape[concat_axis]
    out_shape[concat_axis] *= n
    return recv.reshape(out_shape)


# ------------------------------------------------------ partition rules ---

# (regex on '/'-joined path, spec WITHOUT the stacked-layer axis)
_RULES = (
    (r"embed$",                      P("model", None)),
    (r"head$",                       P(None, "model")),
    (r"(attn|self_attn|cross_attn)/w[qkv]$", P(None, "model")),
    (r"(attn|self_attn|cross_attn)/wo$",     P("model", None)),
    (r"(attn|self_attn|cross_attn)/b[qkv]$", P("model")),
    # moe experts: expert-parallel over the model axis
    (r"moe/w[gu]$",                  P("model", None, None)),
    (r"moe/wd$",                     P("model", None, None)),
    (r"moe/router$",                 P(None, None)),
    (r"moe/shared/w[gu]$",           P(None, "model")),
    (r"moe/shared/wd$",              P("model", None)),
    # dense mlp
    (r"mlp/w[gu]$",                  P(None, "model")),
    (r"mlp/wd$",                     P("model", None)),
    (r"mlp/b[ud]$",                  P(None)),
    # rwkv time-mix / channel-mix
    (r"tm/w[rkvg]$",                 P(None, "model")),
    (r"tm/wo$",                      P("model", None)),
    (r"tm/(mix_A|mix_B|w_A|w_B|mu|w0|u|gn_scale)$", None),  # small, replicated
    (r"cm/w[k]$",                    P(None, "model")),
    (r"cm/wv$",                      P("model", None)),
    (r"cm/wr$",                      P(None, "model")),
    (r"cm/(mu_k|mu_r)$",             None),
    # rglru recurrent blocks
    (r"rec/w[xy]$",                  P(None, "model")),
    (r"rec/wo$",                     P("model", None)),
    (r"rec/conv_[wb]$",              None),
    (r"rec/(gate_a|gate_x)/[wb]$",   None),
    (r"rec/lam$",                    None),
)


def _path_str(path) -> str:
    """A leaf's path (dict keys and list indices) joined with '/'."""
    return "/".join(str(k) for k in path)


def spec_for(path_str: str, ndim: int, stacked: bool,
             shape=None, model_divisor: int = 16) -> P:
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            if spec is None:
                return P()
            want = len(spec) + (1 if stacked else 0)
            if ndim == want and stacked:
                spec = P(None, *spec)
            elif ndim != len(spec):
                # dimensionality mismatch (e.g. layer-stacked bias): replicate
                return P()
            if shape is not None:
                # drop 'model' from dims the axis size does not divide
                # (e.g. whisper's vocab 51865)
                spec = P(*(None if (ax == "model" and dim % model_divisor)
                           else ax for ax, dim in zip(tuple(spec), shape)))
            return spec
    return P()   # default: replicated (norms, scalars)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in
               enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree)


def param_specs(params, *, stacked_blocks_key: str = "blocks",
                model_divisor: int = 16):
    """A spec tree matching ``params`` (tensors, meta tensors included);
    layer-stacked subtrees (under ``blocks``) get a leading None axis."""

    def per_leaf(path, leaf):
        ps = _path_str(path)
        stacked = ps.startswith(stacked_blocks_key + "/") or \
            ("/" + stacked_blocks_key + "/") in ps
        return spec_for(ps, leaf.dim(), stacked, shape=tuple(leaf.shape),
                        model_divisor=model_divisor)

    return _map_with_path(per_leaf, params)


def data_axes(mesh):
    names = mesh_shape(mesh)
    return ("pod", "data") if "pod" in names else ("data",)


def batch_spec(mesh) -> P:
    return P(data_axes(mesh), None)


def _placements(mesh, spec):
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(tuple(spec)):
        axes = _axes_tuple(axes)
        if len(axes) > 1:
            raise NotImplementedError(
                f"a dim sharded over several mesh axes {axes} has no "
                f"DTensor placement here")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def shardings(mesh, specs):
    """Each spec of the tree as DTensor placements, one per mesh dim
    (``Shard(i)`` where dim i is sharded over that axis, else
    ``Replicate()``)."""
    return _map_with_path(lambda _, s: _placements(mesh, s), specs)


def opt_state_specs(param_spec_tree, opt_state):
    """AdamW mu/nu shard exactly like their parameters."""
    from ..optim import OptState
    return OptState(mu=param_spec_tree, nu=param_spec_tree, count=P())


def zero_specs(pspecs, params_shapes, mesh):
    """ZeRO-style widening: additionally shard the first replicated,
    divisible dim of every param over the 'data' axis (for the float32
    optimizer moments and the microbatch gradient accumulator)."""
    dsz = mesh_shape(mesh).get("data", 1)
    if dsz <= 1:
        return pspecs

    def widen(path, spec):
        leaf = params_shapes
        for k in path:
            leaf = leaf[k]
        s = list(tuple(spec) + (None,) * (leaf.dim() - len(spec)))
        for i, (ax, dim) in enumerate(zip(s, leaf.shape)):
            if ax is None and dim % dsz == 0:
                s[i] = "data"
                return P(*s)
        return P(*s)

    return _map_with_path(widen, pspecs)


# ----------------------------------------------- placed (DTensor) trees ---

def place(x, mesh, placements):
    """``x`` (the same global value on every rank) as a DTensor with
    ``placements`` on ``mesh``: each rank keeps its block, nothing moves."""
    from torch.distributed.tensor import DTensor, Replicate

    dm = _device_mesh(mesh)
    rep = [Replicate()] * dm.ndim
    return DTensor.from_local(x, dm, rep, run_check=False).redistribute(
        dm, placements)


def place_tree(tree, mesh, placements):
    """:func:`place` over a tree and its placements tree
    (:func:`shardings`)."""
    return _map_with_path(
        lambda path, x: place(x, mesh, _at(placements, path)), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gather_full(tree):
    """Every DTensor leaf of ``tree`` as its whole value (all-gathered);
    other leaves as they are."""
    return _map_with_path(
        lambda _, x: x.full_tensor() if is_placed(x) else x, tree)


def place_like(tree, like):
    """``tree``'s leaves (global values) placed as the DTensor leaves of
    ``like`` are; leaves whose counterpart is not a DTensor as they are."""
    return _map_with_path(
        lambda path, x: place(x, _at(like, path).device_mesh,
                              _at(like, path).placements)
        if is_placed(_at(like, path)) else x, tree)
