"""The port's collectives (``repro_torch.distributed.collectives``) against
the JAX package on the CPU: the int8 gradient compression with error
feedback bit for bit (tests/test_infra.py:114, :123), and ``chunked_psum``
inside the port's ``shard_map`` at world 1 (in this process) and world 4
(a gloo world, tests/torch_dist.py; tests/test_infra.py:137)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as D
from repro.distributed import collectives as J
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import P, shard_map
from repro_torch.launch.mesh import close_world, init_world

WORLD = 4
#: (shape, scale) of the compressed gradients: JAX's two tests' own, a
#: wide, a small-scale and a large-scale one.
CASES = [((256, 64), 3.0), ((128,), 0.01), ((200, 37), 1e-3), ((7,), 1e5),
         ((3, 5, 9), 1.0)]


def _grad(shape, scale, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _same(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape,scale", CASES)
def test_int8_roundtrip_is_jax_bit_for_bit(shape, scale):
    g = _grad(shape, scale)
    q, s = C.compress_int8(torch.from_numpy(g))
    jq, js = J.compress_int8(jnp.asarray(g))
    _same(q, jq)
    _same(s, js)
    deq = C.decompress_int8(q, s)
    _same(deq, J.decompress_int8(jq, js))
    # JAX's own bound: half an ulp of the quantization grid
    assert float((deq - torch.from_numpy(g)).abs().max()) <= \
        float(s) * 0.5 + 1e-6
    assert q.dtype == torch.int8
    assert C.decompress_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("shape,scale", CASES)
def test_error_feedback_is_jax_bit_for_bit(shape, scale):
    """16 steps of compressed_grad_tree over a tree, the errors carried:
    every q, scale and error equals JAX's; the accumulated error stays
    bounded (JAX's test's 5%)."""
    g = {"w": _grad(shape, scale, 1), "blocks": {"b": _grad((4, 3), 1.0, 2)}}
    tg = {"w": torch.from_numpy(g["w"]),
          "blocks": {"b": torch.from_numpy(g["blocks"]["b"])}}
    jg = jax.tree.map(jnp.asarray, g)
    te = je = None
    acc = torch.zeros_like(tg["w"])
    for _ in range(16):
        tq, ts, te = C.compressed_grad_tree(tg, te)
        jq, js, je = J.compressed_grad_tree(jg, je)
        for a, b in zip((tq, ts, te), (jq, js, je)):
            _same(a["w"], b["w"])
            _same(a["blocks"]["b"], b["blocks"]["b"])
        acc = acc + C.decompress_int8(tq["w"], ts["w"])
    true = tg["w"] * 16
    assert float(torch.linalg.norm(acc - true) / torch.linalg.norm(true)) \
        < 0.05


def test_chunked_psum_world_1():
    """tests/test_infra.py:137: a one-rank ("x",) mesh, P() in and out."""
    from torch.distributed.device_mesh import DeviceMesh

    started = init_world("cpu")
    try:
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("x",))
        x = torch.arange(8.0)
        y = shard_map(lambda v: C.chunked_psum(v, "x", num_chunks=4),
                      mesh=mesh, in_specs=P(), out_specs=P())(x)
    finally:
        if started:
            close_world()
    assert torch.equal(y, x)


def test_chunked_psum_outside_shard_map_raises():
    with pytest.raises(NameError, match="shard_map"):
        C.chunked_psum(torch.arange(8.0), "x")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return D.join(D.start_world("collectives", WORLD,
                                tmp_path_factory.mktemp("coll")))


def test_chunked_psum_world_4_sums_the_blocks(world4):
    x = np.arange(4.0 * WORLD * 2, dtype=np.float32)
    for r in world4:
        np.testing.assert_array_equal(r["sharded"],
                                      x.reshape(WORLD, -1).sum(0))
        np.testing.assert_array_equal(r["replicated"], WORLD * x)


@pytest.mark.parametrize("case", ["float", "odd", "scalar", "one_chunk"])
def test_chunked_psum_world_4_equals_one_psum(world4, case):
    """A leading dim 4 does not divide (7), a scalar and one chunk fall
    back to the single psum, bit for bit; four chunks agree with it to the
    order gloo sums a buffer of each size in; every rank gets the sum of
    the ranks' values."""
    gs = [r["g"] for r in world4]
    want = {"float": sum(gs), "odd": sum(g[:7] for g in gs),
            "scalar": sum(g[0, 0] for g in gs), "one_chunk": sum(gs)}[case]
    for r in world4:
        chunked, whole = r[case]
        if case == "float":
            np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(chunked, whole)
        np.testing.assert_allclose(chunked, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(chunked, world4[0][case][0])
