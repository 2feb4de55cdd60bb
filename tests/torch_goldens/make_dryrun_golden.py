"""Regenerate ``dryrun_specs.json``: the JAX package's dry-run inputs
(``repro.launch.input_specs.input_specs``) for every arch of
``configs.ARCHS``, every cell of ``configs.cells`` and two meshes, 2 x 2
and 16 x 16 ``("data", "model")``, over 512 forced host devices: each
input leaf's shape, dtype and PartitionSpec.

    PYTHONPATH=src python tests/torch_goldens/make_dryrun_golden.py

The devices need ``XLA_FLAGS`` before JAX is imported, which the script
sets; a test worker has imported JAX already, hence this file.  A leaf's
path joins its dict keys and sequence indices with '/' (a decode state's
``state/0/k``); a spec entry is null, an axis name, or a list of names (a
tuple of one name is that name, as the port's ``P`` normalises it).
tests/test_torch_dryrun.py holds the port's ``input_specs`` to it leaf for
leaf.  Runs in ~10 s.
"""
import json
import os
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS, cells, get_config  # noqa: E402
from repro.launch.input_specs import input_specs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}


def spec_json(spec):
    out = []
    for ax in tuple(spec):
        if isinstance(ax, tuple):
            ax = None if not ax else ax[0] if len(ax) == 1 else list(ax)
        out.append(ax)
    return out


def path_str(path) -> str:
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            parts.append(str(k.idx))
        else:
            raise TypeError(f"unexpected key {k!r}")
    return "/".join(parts)


def main():
    t0 = time.perf_counter()
    devs = np.array(jax.devices())
    assert devs.size >= 512, devs.size
    out = {"source": f"repro.launch.input_specs.input_specs, JAX "
                     f"{jax.__version__} on 512 host CPU devices",
           "cells": []}
    for mname, shape in MESHES.items():
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                    ("data", "model"))
        for arch in ARCHS:
            cfg = get_config(arch)
            for cell in cells(arch):
                inputs, shards, kind = input_specs(cfg, cell, mesh)
                leaves = {}
                flat = jax.tree_util.tree_flatten_with_path(inputs)[0]
                specs = jax.tree_util.tree_leaves(shards)
                assert len(flat) == len(specs), (arch, cell)
                for (path, leaf), sh in zip(flat, specs):
                    leaves[path_str(path)] = {
                        "shape": list(leaf.shape),
                        "dtype": str(np.dtype(leaf.dtype)),
                        "spec": spec_json(sh.spec)}
                out["cells"].append({"mesh": mname, "arch": arch,
                                     "shape": cell, "kind": kind,
                                     "leaves": leaves})
    path = os.path.join(HERE, "dryrun_specs.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    print(f"wrote {path}: {len(out['cells'])} cells in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
