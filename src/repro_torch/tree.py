"""Parameter trees as ``jax.tree`` sees them: nested dicts, lists (and
NamedTuples) whose leaves are tensors, flattened in JAX's order -- dict keys
sorted, list items and NamedTuple fields in order -- so that sums over
leaves and checkpoint files line up with the JAX package's (recurrentgemma
keeps its layers as a list of dicts)."""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = ""):
    """[(path, leaf)] in JAX's flatten order; paths as the JAX package's
    checkpoints write them (``.field`` for a NamedTuple field, ``/key`` for
    a dict key, ``/i`` for a list item, e.g. ``.params/blocks/attn/wq``,
    ``.params/layers/2/attn/wq``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            sep = "/" if prefix else ""
            out += leaves_with_paths(tree[k], f"{prefix}{sep}{k}")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            sep = "/" if prefix else ""
            out += leaves_with_paths(getattr(tree, f), f"{prefix}{sep}.{f}")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            sep = "/" if prefix else ""
            out += leaves_with_paths(v, f"{prefix}{sep}{i}")
        return out
    return [(prefix, tree)]


def leaves(tree):
    """The leaves in JAX's flatten order."""
    return [x for _, x in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, v, *[r[i] for r in rest])
                            for i, v in enumerate(tree)])
    if isinstance(tree, list):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten_like(like, values):
    """A tree shaped like ``like`` whose leaves, in JAX's flatten order, are
    ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), _in_flatten_order(like))


def _in_flatten_order(tree):
    """``tree`` with its dicts' keys in sorted order (so that
    :func:`tree_map` visits leaves in JAX's flatten order)."""
    if isinstance(tree, dict):
        return {k: _in_flatten_order(tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*[_in_flatten_order(v) for v in tree])
    if isinstance(tree, list):
        return [_in_flatten_order(v) for v in tree]
    return tree
