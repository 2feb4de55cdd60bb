"""The port's multi-rank base on the CPU: ``launch/mesh.py``, the mesh half
of ``distributed/sharding.py`` and the launchers' ``--tp``.

Against the JAX package (tests/test_infra.py:72, :85, :104): the partition
rules and spec trees of every arch, the 16-way divisibility of every full
config (shapes from ``init_params(..., device="meta")``, the port's
``jax.eval_shape``, itself held to JAX's), ``zero_specs`` and
``batch_spec``.  On gloo worlds of 2 and 4 ranks (tests/torch_dist.py):
the host mesh's shapes and groups, ``shard_map``'s cut, reassembly and
gradient, placed trees, ``--tp 2`` serving and training against tp 1
(training bit for bit at one data rank, to 1e-6 over two in float32), the
placed step under ``moe_impl="a2a"`` at two data ranks against the global
one and gmm, and the production meshes on torch's fake process group.
"""
import types

import jax
import numpy as np
import pytest
import torch

import torch_dist as D
from repro.configs import ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.distributed import sharding as JS
from repro.models import build as jbuild
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.models import build as tbuild

#: float32 losses over two data ranks against one: the per-rank means
#: averaged against one mean (measured 1.9e-7 relative).
DATA2_F32_RTOL = 1e-6
#: bf16 (the smoke config's dtype): the bf16 gradients of two half batches
#: averaged, against one batch's, differ by a bf16 ulp, and Adam's first
#: steps move a weight by its gradient's sign (measured 6.2e-6).
DATA2_BF16_RTOL = 1e-4
#: bf16 losses at model 2 against model 1: the partitioned step sums the
#: row products of two ranks' bf16 halves (measured 6.0e-5).
MODEL2_BF16_RTOL = 1e-4


def _jax_specs(shapes, **kw):
    specs = JS.param_specs(shapes, **kw)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {JS._path_str(p): tuple(s) for p, s in flat}


def _port_specs(params, **kw):
    out = {}
    S._map_with_path(lambda p, s: out.setdefault(S._path_str(p), tuple(s)),
                     S.param_specs(params, **kw))
    return out


def _jax_shapes(cfg):
    shapes = jax.eval_shape(jbuild(cfg).init_params, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {JS._path_str(p): (tuple(x.shape), str(x.dtype)) for p, x in flat}


def _port_shapes(cfg):
    out = {}
    S._map_with_path(lambda p, x: out.setdefault(
        S._path_str(p), (tuple(x.shape), str(x.dtype).replace("torch.", ""))),
        tbuild(cfg).init_params(0, device="meta"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_are_jax_eval_shape(arch):
    """``init_params(..., device="meta")`` draws nothing and gives JAX's
    shapes and dtypes, leaf by leaf, for the smoke and the full config."""
    for j, t in ((j_smoke, t_smoke), (j_config, t_config)):
        got = _port_shapes(t(arch))
        assert got == _jax_shapes(j(arch))
    leaf = tbuild(t_config(arch)).init_params(0, device="meta")["embed"]
    assert leaf.device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_leaf_by_leaf(arch):
    """tests/test_infra.py:72: every leaf has a spec, and the port's spec
    tree is JAX's by path string (smoke config; model divisors 16 and
    2)."""
    jshapes = jax.eval_shape(jbuild(j_smoke(arch)).init_params,
                             jax.random.PRNGKey(0))
    params = tbuild(t_smoke(arch)).init_params(0, device="meta")
    for div in (16, 2):
        want = _jax_specs(jshapes, model_divisor=div)
        got = _port_specs(params, model_divisor=div)
        assert got == want
        assert len(got) == len(jax.tree.leaves(jshapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shardable_on_16way_model_axis(arch):
    """tests/test_infra.py:85 on the port: every model-sharded dim of every
    full config divides by 16 (meta shapes, nothing allocated), and the
    spec tree is JAX's."""
    params = tbuild(t_config(arch)).init_params(0, device="meta")
    specs = S.param_specs(params)
    n = 0

    def check(path, leaf):
        nonlocal n
        spec = S._at(specs, path)
        for dim, ax in zip(leaf.shape, tuple(spec)):
            if ax == "model":
                n += 1
                assert dim % 16 == 0, (arch, path, tuple(leaf.shape), spec)
    S._map_with_path(check, params)
    assert n > 0
    jshapes = jax.eval_shape(jbuild(j_config(arch)).init_params,
                             jax.random.PRNGKey(0))
    assert _port_specs(params) == _jax_specs(jshapes)


SPEC_CASES = [("embed", 2, False, None), ("blocks/attn/wq", 3, True, None),
              ("blocks/moe/wg", 4, True, None),
              ("layers/0/rec/wx", 2, False, None),
              ("final_norm/scale", 1, False, None),
              ("embed", 2, False, (51865, 768)),
              ("blocks/attn/bq", 2, True, None),
              ("blocks/tm/mix_A", 4, True, None),
              ("dec_layers/3/cross_attn/wo", 2, False, (768, 768)),
              ("blocks/moe/shared/wd", 3, True, (48, 1408, 2048)),
              ("blocks/mlp/bu", 2, True, None)]


@pytest.mark.parametrize("path,ndim,stacked,shape", SPEC_CASES)
def test_spec_for_rules_are_jax(path, ndim, stacked, shape):
    """tests/test_infra.py:104 and more: the same spec as JAX's."""
    want = JS.spec_for(path, ndim, stacked, shape=shape)
    got = S.spec_for(path, ndim, stacked, shape=shape)
    assert isinstance(got, S.P) and tuple(got) == tuple(want)


def _duck_meshes(shape):
    """(JAX-side, port-side) stand-ins of a mesh of ``shape`` (a dict):
    what ``data_axes``, ``batch_spec`` and ``zero_specs`` read of it."""
    j = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    t = S.AbstractMesh(types.SimpleNamespace(
        mesh_dim_names=tuple(shape), mesh=torch.empty(tuple(shape.values()))))
    return j, t


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2},
                                   {"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"data": 1, "model": 4}])
def test_batch_and_zero_specs_are_jax(shape):
    jm, tm = _duck_meshes(shape)
    assert S.data_axes(tm) == JS.data_axes(jm)
    assert tuple(S.batch_spec(tm)) == tuple(JS.batch_spec(jm))
    cfg = "qwen3-moe-30b-a3b"
    jshapes = jax.eval_shape(jbuild(j_config(cfg)).init_params,
                             jax.random.PRNGKey(0))
    params = tbuild(t_config(cfg)).init_params(0, device="meta")
    jz = JS.zero_specs(JS.param_specs(jshapes), jshapes, jm)
    tz = S.zero_specs(S.param_specs(params), params, tm)
    flat = jax.tree_util.tree_flatten_with_path(
        jz, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {JS._path_str(p): tuple(s) for p, s in flat}
    got = {}
    S._map_with_path(lambda p, s: got.setdefault(S._path_str(p), tuple(s)),
                     tz)
    assert got == want
    opt = S.opt_state_specs(tz, None)
    assert opt.mu is tz and opt.nu is tz and tuple(opt.count) == tuple(
        JS.opt_state_specs(jz, None).count)


def test_set_mesh_and_the_empty_abstract_mesh():
    am = S.get_abstract_mesh()
    assert am.empty and am.shape == {} and am.axis_names == ()
    _, tm = _duck_meshes({"data": 1, "model": 2})
    with S.set_mesh(tm):
        am = S.get_abstract_mesh()
        assert not am.empty and am.shape == {"data": 1, "model": 2}
        assert am.axis_names == ("data", "model")
    assert S.get_abstract_mesh().empty


def test_production_mesh_raises_at_world_1():
    """A 16 x 16 mesh without 256 ranks raises, as jax.make_mesh does
    without the devices; so do the launchers' --tp beyond the world."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    started = M.init_world("cpu")
    try:
        for multi in (False, True):
            with pytest.raises(ValueError, match="Number of ranks 1"):
                M.make_production_mesh(multi_pod=multi, device="cpu")
        with pytest.raises(ValueError, match="mesh_shape"):
            M.make_host_mesh(model=2, device="cpu")
    finally:
        if started:
            M.close_world()
    with pytest.raises(ValueError, match="mesh_shape"):
        ttrain.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                     "--production-mesh"])
    with pytest.raises(ValueError, match=r"mesh_shape \(1, 2\)"):
        tserve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--smoke",
                     "--tp", "2"])


# ------------------------------------------------------------- worlds ---

#: Each world runs its cases in turn: (ranks, [[name, case, keywords]]).
#: The world of one runs the launchers at tp 1 (each starting its own world
#: of one), then the production meshes on the fake process group.
WORLDS = {
    "2x2": (4, [["mesh", "mesh", {}], ["train", "train", {"tp": 2}],
                ["train_f32", "train", {"tp": 2, "dtype": "float32"}],
                ["train_a2a", "train_a2a", {}]]),
    "1x2": (2, [["serve", "serve", {"tp": 2}],
                ["train", "train", {"tp": 2}],
                ["train_mb", "train", {"tp": 2, "microbatches": 2}]]),
    "1": (1, [["serve", "serve", {"tp": 1}], ["train", "train", {"tp": 1}],
              ["train_f32", "train", {"tp": 1, "dtype": "float32"}],
              ["train_mb", "train", {"tp": 1, "microbatches": 2}],
              ["production", "production", {}]])}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: every rank's {case name: result}}: the worlds started at
    once, then joined."""
    tmp = tmp_path_factory.mktemp("mesh")
    started = {k: D.start_world("many", n, tmp / k, parts=parts)
               for k, (n, parts) in WORLDS.items()}
    return {k: D.join(w) for k, w in started.items()}


def test_host_mesh_shapes_and_groups(worlds):
    ranks = [r["mesh"] for r in worlds["2x2"]]
    for r, res in enumerate(ranks):
        assert res["shape_1"] == {"data": 4, "model": 1}
        assert res["shape_2"] == {"data": 2, "model": 2}
        assert res["shape_4"] == {"data": 1, "model": 4}
        assert res["coord_2"] == (r // 2, r % 2)
        assert res["model_ranks_2"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert res["model_ranks_1"] == [r]
        assert res["model_ranks_4"] == [0, 1, 2, 3]
        for m in (1, 2, 4):
            assert res[f"all_ranks_{m}"] == [0, 1, 2, 3]
        assert "Number of ranks 4" in res["too_wide"]
        assert res["abstract"] == (False, {"data": 2, "model": 2},
                                   ("data", "model"))


def test_shard_map_cut_reassembly_and_gradient(worlds):
    """x [4, 6] cut P("data", "model") on 2 x 2; each block times (1 +
    its model index); a pmean over both axes of the blocks' sums as a P()
    output.  Every rank: the global y, s and the gradient of sum(y^2) +
    3 s."""
    x = np.arange(24.0, dtype=np.float32).reshape(4, 6)
    f = np.repeat([[1.0, 1.0, 1.0, 2.0, 2.0, 2.0]], 4, axis=0)
    want_y = x * f
    want_s = x.sum() / 4
    want_g = 2 * x * f * f + 3.0 / 4
    for res in (r["mesh"] for r in worlds["2x2"]):
        np.testing.assert_array_equal(res["y"], want_y)
        np.testing.assert_allclose(res["s"], want_s, rtol=1e-7)
        np.testing.assert_allclose(res["grad"], want_g, rtol=1e-6)


def test_placed_trees_round_trip(worlds):
    """qwen3-0.6b smoke placed by shardings(param_specs) on 2 x 2: each
    rank keeps its block, gather_full gives the tree back bit for bit;
    zero_specs widens over 'data' as JAX's does."""
    jm, _ = _duck_meshes({"data": 2, "model": 2})
    jshapes = jax.eval_shape(jbuild(j_smoke("qwen3-0.6b")).init_params,
                             jax.random.PRNGKey(0))
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(
        JS.zero_specs(JS.param_specs(jshapes, model_divisor=2), jshapes, jm),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {JS._path_str(p): tuple(s) for p, s in flat}
    for res in (r["mesh"] for r in worlds["2x2"]):
        assert res["roundtrip"]
        cfg = t_smoke("qwen3-0.6b")
        L, d = cfg.num_layers, cfg.d_model
        assert res["local_wq"] == (L, d, cfg.num_heads * cfg.head_dim // 2)
        got = {}
        S._map_with_path(lambda p, s: got.setdefault(S._path_str(p),
                                                     tuple(s)), res["zero"])
        assert got == want


def test_serve_tp2_is_tp1(worlds):
    """JAX places no parameter when serving: every rank's tokens are tp
    1's."""
    (tp1,) = worlds["1"]
    for r in worlds["1x2"]:
        np.testing.assert_array_equal(r["serve"], tp1["serve"])


@pytest.mark.parametrize("world,case,rtol", [
    ("1x2", "train", MODEL2_BF16_RTOL), ("1x2", "train_mb", MODEL2_BF16_RTOL),
    ("2x2", "train_f32", DATA2_F32_RTOL), ("2x2", "train", DATA2_BF16_RTOL)])
def test_train_on_a_mesh_is_tp1(worlds, world, case, rtol):
    """3 launcher steps on a (1, 2) mesh equal tp 1's to the partitioned
    step's bf16 row sums (two microbatches too); on (2, 2), to the mean
    over two data ranks and those sums (float32:
    tests/test_torch_tensor_parallel.py holds the dense family to JAX)."""
    want = np.asarray(worlds["1"][0][case])
    for r in worlds[world]:
        got = np.asarray(r[case])
        assert np.isfinite(got).all() and got.shape == (3,)
        if rtol == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
        np.testing.assert_array_equal(got, np.asarray(worlds[world][0][case]))


def test_placed_a2a_step_at_two_data_ranks(worlds):
    """qwen3-moe smoke (float32) under moe_impl="a2a" on 2 x 2, two steps:
    the placed state's step is the partitioned one (each rank its block
    of the batch, cut by sequence over 'model', and its experts), the
    plain state's runs moe_a2a's shard_map on global arrays; both route
    each rank's same tokens, so their losses agree to the data mean's
    round-off (``DATA2_F32_RTOL``; measured 7.6e-8) and their final
    weights to test_torch_train's 5e-5 (measured 1.2e-5), on every rank.
    At ample capacity the first cross-entropy is the gmm step's without a
    mesh, to test_torch_moe_a2a's 1e-5 (the loss and the second step
    differ by design: a2a's aux is the mean of each shard's estimate)."""
    from repro_torch.tree import leaves

    for r in worlds["2x2"]:
        res = r["train_a2a"]
        assert np.isfinite(res["placed"]["losses"]).all()
        np.testing.assert_allclose(res["placed"]["losses"],
                                   res["global"]["losses"],
                                   rtol=DATA2_F32_RTOL)
        for a, b in zip(leaves(res["placed"]["params"]),
                        leaves(res["global"]["params"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)
        np.testing.assert_allclose(res["ample"]["ce"][0],
                                   res["gmm"]["ce"][0], rtol=1e-5, atol=0)


def test_production_meshes_on_the_fake_group(worlds):
    res = worlds["1"][0]["production"]
    assert res[256] == ({"data": 16, "model": 16}, ("data", "model"),
                        (16, 16))
    assert res[512] == ({"pod": 2, "data": 16, "model": 16},
                        ("pod", "data", "model"), (2, 16, 16))
