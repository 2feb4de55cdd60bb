"""Regenerate ``moe_a2a.json``: the JAX package's expert-parallel MoE
(``repro.distributed.moe_a2a.moe_a2a``) under a 2 x 2 ``("data",
"model")`` mesh of four host devices, on tests/torch_dist.py's inputs
(numpy seeds; float32 weights): the output and aux loss at capacity
factors 8.0 and 0.5, and the gradients of ``sum(y^2) + aux`` (JAX's
``test_a2a_differentiable`` loss, here also with respect to x) at 4.0 and,
with T = 7 (which the model axis does not divide), at 8.0.

    PYTHONPATH=src:tests python tests/torch_goldens/make_moe_a2a_golden.py

The four devices need ``XLA_FLAGS`` before JAX is imported, which the
script sets; a test worker has imported JAX already, hence this file.
Arrays are stored as base64 of little-endian float32.  The port holds its
``moe_a2a`` on a gloo world of four ranks against it
(tests/test_torch_moe_a2a.py).
"""
import base64
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist  # noqa: E402
from repro.distributed.moe_a2a import moe_a2a  # noqa: E402
from repro.distributed.sharding import set_mesh  # noqa: E402
from repro.models import common  # noqa: E402

#: (tag, T or None for the default, capacity factor, with gradients)
CASES = (("ample", None, 8.0, False), ("tight", None, 0.5, False),
         ("grad", None, 4.0, True), ("t7", 7, 8.0, True))


def b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(
        np.asarray(a, np.float32)).astype("<f4").tobytes()).decode()


def main():
    t0 = time.perf_counter()
    assert len(jax.devices()) >= 4, jax.devices()
    cfg = torch_dist.moe_config(common=common)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {"source": "repro.distributed.moe_a2a.moe_a2a, JAX "
                     f"{jax.__version__} on 4 host CPU devices, mesh 2 x 2",
           "shapes": torch_dist.MOE, "cases": {}}
    for tag, T, cf, grad in CASES:
        pn, xn = torch_dist.moe_inputs(T)
        p = {k: jnp.asarray(v) for k, v in pn.items()}
        x = jnp.asarray(xn)

        def run(p, x, cf=cf):
            return moe_a2a(cfg, p, x, capacity_factor=cf)

        def loss(p, x, cf=cf):
            y, aux = moe_a2a(cfg, p, x, capacity_factor=cf)
            return jnp.sum(jnp.square(y.astype(jnp.float32))) + aux

        with set_mesh(mesh):
            y, aux = jax.jit(run)(p, x)
            rec = {"capacity_factor": cf, "T": int(x.shape[1]),
                   "y": b64(y), "aux": float(aux)}
            if grad:
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                rec["grads"] = {**{k: b64(v) for k, v in gp.items()},
                                "x": b64(gx)}
        out["cases"][tag] = rec
        print(f"{tag}: capacity factor {cf}, T {x.shape[1]}: aux "
              f"{float(aux):.6f}, |y| max {float(jnp.abs(y).max()):.4f}")
    path = os.path.join(HERE, "moe_a2a.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
