"""The port's expert-parallel MoE (``repro_torch.distributed.moe_a2a``)
against the JAX package on the CPU: a gloo world of four ranks on a 2 x 2
``("data", "model")`` mesh (tests/torch_dist.py), on tests/test_moe_a2a.py's
shapes (8 experts top-2, d 32, ff 64, x [4, 8, 32]; float32 weights from
numpy seeds).

Oracles:
(i)   ample capacity (factor 8.0): equal to the port's ``moe_gmm`` and to
      JAX's ``moe_gmm`` outside any mesh, to 1e-5 (JAX's own test's
      tolerance).  JAX's ``test_a2a_matches_gmm_with_ample_capacity``
      fails in the seed on its reference side: JAX's ``moe_gmm`` under the
      explicit mesh (``jnp.repeat``, src/repro/models/layers.py:514), not
      on ``moe_a2a``.
(ii)  tight capacity (0.5): output and aux against JAX's ``moe_a2a`` under
      a 2 x 2 host mesh (tests/torch_goldens/moe_a2a.json, made by
      ``make_moe_a2a_golden.py``), to 1e-5 and 1e-6; the aux is the mesh
      mean of each rank's local estimate, not ``moe_gmm``'s.
(iii) the gradient of ``sum(y^2) + aux`` at 4.0 (JAX's
      ``test_a2a_differentiable`` loss) against ``jax.grad`` under the mesh,
      to ``GRAD_TOL``; and at a T (7) the model axis does not divide, where
      every model rank routes the same tokens, output and gradient.
"""
import base64
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as D
from repro.models import common as jcommon
from repro.models import layers as JL
from repro_torch.distributed.moe_a2a import dispatch_slots, moe_a2a
from repro_torch.distributed.sharding import set_mesh
from repro_torch.launch.mesh import close_world, make_host_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import layers as TL

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_goldens",
                      "moe_a2a.json")
#: JAX's tests/test_moe_a2a.py tolerance for a2a against gmm.
Y_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6
#: The gradients against jax.grad: sums over the ranks' tokens in another
#: order (measured 3.4e-7 and 4.0e-7 of the largest |gradient|).
GRAD_TOL = 1e-5


def _f32(s, shape):
    return np.frombuffer(base64.b64decode(s), "<f4").reshape(shape)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the 2 x 2 world (tests/torch_dist.py
    ``case_moe_a2a``)."""
    return D.join(D.start_world("moe_a2a", 4, tmp_path_factory.mktemp("a2a")))


def _gmm(T=None):
    """(port's moe_gmm, JAX's moe_gmm outside a mesh) on the inputs."""
    pn, xn = D.moe_inputs(T)
    ty, ta = TL.moe_gmm(D.moe_config(common=tcommon),
                        {k: torch.from_numpy(v) for k, v in pn.items()},
                        torch.from_numpy(xn))
    jy, ja = JL.moe_gmm(D.moe_config(common=jcommon),
                        {k: jnp.asarray(v) for k, v in pn.items()},
                        jnp.asarray(xn))
    return (ty.numpy(), float(ta)), (np.asarray(jy), float(ja))


def test_every_rank_returns_the_same_global_values(ranks):
    for r in ranks[1:]:
        for tag in ranks[0]:
            np.testing.assert_array_equal(r[tag]["y"], ranks[0][tag]["y"])
            assert r[tag]["aux"] == ranks[0][tag]["aux"]


@pytest.mark.parametrize("tag,T", [("ample", None), ("t7", 7)])
def test_ample_capacity_equals_gmm(ranks, golden, tag, T):
    """(i): no token drops, so the a2a is the dropless gmm; T 7 too."""
    (ty, _), (jy, _) = _gmm(T)
    y = ranks[0][tag]["y"]
    np.testing.assert_allclose(y, ty, **Y_TOL)
    np.testing.assert_allclose(y, jy, **Y_TOL)
    jax_a2a = _f32(golden["cases"][tag]["y"], y.shape)
    np.testing.assert_allclose(y, jax_a2a, **Y_TOL)


def test_tight_capacity_against_jax_a2a(ranks, golden):
    """(ii): tokens drop by each rank's own order; the aux is the pmean of
    the ranks' local estimates (gmm's global one differs)."""
    g = golden["cases"]["tight"]
    y, aux = ranks[0]["tight"]["y"], float(ranks[0]["tight"]["aux"])
    np.testing.assert_allclose(y, _f32(g["y"], y.shape), **Y_TOL)
    assert abs(aux - g["aux"]) <= AUX_TOL
    (ty, t_aux), (_, j_aux) = _gmm()
    assert abs(t_aux - j_aux) <= AUX_TOL
    assert abs(aux - t_aux) > 100 * AUX_TOL
    assert np.abs(y - ty).max() > 1e-2        # something was dropped


@pytest.mark.parametrize("tag", ["grad", "t7"])
def test_gradients_against_jax_grad(ranks, golden, tag):
    """(iii): d(sum(y^2) + aux) / d(router, wg, wu, wd, x) on every rank
    equals JAX's under the mesh."""
    g = golden["cases"][tag]
    for r in ranks:
        for name, got in r[tag]["grads"].items():
            want = _f32(g["grads"][name], got.shape)
            scale = float(np.abs(want).max())
            assert scale > 0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"{tag} d/d{name}")
        np.testing.assert_allclose(float(r[tag]["aux"]), g["aux"],
                                   atol=AUX_TOL)


@pytest.mark.parametrize("N,k,E,cap", [(7, 2, 8, 1), (1000, 8, 128, 70),
                                        (64, 2, 8, 10 ** 6)])
def test_dispatch_slots_are_jax_cumsum(N, k, E, cap):
    """Each pair's slot is JAX's ``cumsum(one_hot) - 1`` at its expert
    (src/repro/distributed/moe_a2a.py:80-85), found by a stable sort."""
    rng = np.random.default_rng(N)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(N)])
    flat = jnp.asarray(ids.reshape(-1))
    oh = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = np.asarray(jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1,
                                         flat[:, None], axis=1)[:, 0])
    f, keep, slot = dispatch_slots(torch.from_numpy(ids), E, cap)
    np.testing.assert_array_equal(f.numpy(), ids.reshape(-1))
    np.testing.assert_array_equal(keep.numpy(), pos < cap)
    np.testing.assert_array_equal(slot.numpy(), np.where(pos < cap, pos, cap))


def test_one_rank_mesh_is_gmm_and_no_mesh_falls_back():
    """On a 1 x 1 mesh at ample capacity the a2a equals moe_gmm bit for
    bit; without a mesh (or without a 'model' axis) it is moe_gmm."""
    cfg = D.moe_config(common=tcommon)
    pn, xn = D.moe_inputs()
    p = {k: torch.from_numpy(v) for k, v in pn.items()}
    x = torch.from_numpy(xn)
    yg, ag = TL.moe_gmm(cfg, p, x)
    y0, a0 = moe_a2a(cfg, p, x)
    assert torch.equal(y0, yg) and torch.equal(a0, ag)
    mesh = make_host_mesh(model=1, device="cpu")
    try:
        with set_mesh(mesh):
            y1, a1 = moe_a2a(cfg, p, x, capacity_factor=8.0)
            yt, _ = moe_a2a(cfg, p, x, capacity_factor=0.5)
    finally:
        close_world()
    assert torch.equal(y1, yg) and torch.equal(a1, ag)
    assert not torch.equal(yt, yg)
