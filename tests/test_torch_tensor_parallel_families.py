"""The partitioned train step of the recurrent, VLM and audio families
(rwkv6, recurrentgemma, qwen2-vl, whisper: ``models/rwkv6.py``,
``models/rglru.py``, ``models/lm.py``, ``models/whisper.py`` and the
regions of ``models/layers.py``) on gloo worlds of the CPU against jitted
JAX and the port's own step on one rank.

The ranks (tests/torch_dist.py ``fam``, ``fam_route``) import no JAX;
this process runs JAX while they run.  Worlds, as (data, model) host
meshes: (1, 1), (1, 2), (1, 4) and (2, 2), each started once for all its
parts.  The smoke configs in float32, three steps of B 4 x T 48
(tp_batches, with whisper's 16 frames and qwen2-vl's 2 x 4 image
patches and M-RoPE positions).  rwkv6 smoke's 2 heads at model 4 are
undivided: every rank computes every head, its column blocks gathered.
The variants (``torch_dist.FAM_VARIANTS``, each on the world of
``VARIANT_WORLDS``): the RG-LRU's gates one block wider than a rank's
share; context-parallel attention by ``cp_attention`` (whisper's
cross-attention, qwen2-vl's M-RoPE on the query block, recurrentgemma's
window); whisper's vocabulary padded from 500 to 512, the mask on the
last rank's block; T 45, which the axis does not divide; 30 image
patches, longer than a rank's block.

Tolerances, from the readings these tests take:
  * against JAX, test_torch_train's per arch: loss and ce rtol 2e-6,
    grad_norm rtol 1e-5, lr rtol 1e-6; weights atol 5e-5 where |g| at
    step 1 exceeds 1e-3 x the leaf's largest |g|, else 2 lr a step; the
    first moment rtol 1e-4 + atol ``MU_ATOL`` (1e-5 by default) x the
    leaf's largest.  Two archs read more on these batches already on one
    rank (the 1 x 1 world, one card's step), from the conditioning
    test_torch_train's ``MU_ATOL`` describes (Adam's sign-like first step
    on weights whose gradient is ~eps): rwkv6's grad norm 1.14e-5 at step
    3 (the partitioned runs 1.03e-5 at most) and first moment 3.6e-5;
    recurrentgemma's first moment 5.7e-5 at T 45 (partitioned 2.2e-5;
    1.2e-5 at T 48).  Their entries (``JAX_GNORM_RTOL``, ``MU_ATOL``) are
    about twice the one-rank reading;
  * against the port on one rank, ``TP1_RTOL`` (the dense tests'): loss
    and ce 1e-6, weights 5e-6; the grad norm's per arch
    (``GNORM_TP1_RTOL``): these read up to 1.1e-6 (recurrentgemma, rwkv6
    at (1, 2), step 3) and rwkv6 6.5e-6 at (2, 2), step 3 (the data mean's
    round-off, through Adam's sign-like first steps on the weights whose
    gradient is ~eps, which rwkv6's conditioning then grows; step 1 reads
    at most 1.1e-7); set at 4x the largest reading.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import torch_dist as D
from repro.distributed import sharding as JS
from repro.models import build as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train import make_loss_fn as j_make_loss_fn
from repro_torch.tree import leaves_with_paths

#: name: (ranks, model size); data = ranks / model.
WORLDS = {"1x1": (1, 1), "1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}
TP_WORLDS = ("1x2", "1x4", "2x2")
#: Against the port at one rank (the dense tests' bounds).
TP1_RTOL = dict(loss=1e-6, w=5e-6)
GNORM_TP1_RTOL = {"rwkv6-7b": 2.6e-5, "recurrentgemma-2b": 4.4e-6,
                  "qwen2-vl-2b": 1e-6, "whisper-small": 1e-6}
#: Against JAX: the grad norm's rtol and the first Adam moment's atol as a
#: share of the leaf's largest, where an arch reads more than test_torch_
#: train's defaults (1e-5 each; rwkv6's moment entry is test_torch_train's
#: ``MU_ATOL``): module docstring.
JAX_GNORM_RTOL = {"rwkv6-7b": 2.5e-5}
MU_ATOL = {"rwkv6-7b": 5e-5, "recurrentgemma-2b": 1.2e-4}
VARIANT_WORLDS = {
    "t45/rwkv6-7b": "1x2", "t45/recurrentgemma-2b": "1x2",
    "t45/whisper-small": "1x2", "cp/whisper-small": "1x2",
    "cp/qwen2-vl-2b": "1x2", "gate1/recurrentgemma-2b": "1x4",
    "cp/recurrentgemma-2b": "1x4", "v500/whisper-small": "1x4",
    "tv30/qwen2-vl-2b": "1x4"}
#: The longest a world may take here (its ranks' steps run beside JAX's).
JOIN_S = 240.0


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every world started at once (joined by ``worlds``, after JAX's
    runs, which run meanwhile)."""
    tmp = tmp_path_factory.mktemp("tpf")
    out = {}
    for name, (n, model) in WORLDS.items():
        names = list(D.FAM_ARCHS) + [v for v, w in VARIANT_WORLDS.items()
                                     if w == name]
        parts = [["fam", "fam", {"model": model, "names": names}]]
        if name == "1x1":
            parts.append(["route", "fam_route", {}])
        out[name] = D.start_world("many", n, tmp / name, parts=parts)
    return out


def _jax_steps(name):
    """(metrics of each step, final params, final mu, step-1 gradients) of
    JAX's jitted steps of ``name`` (``D.fam_case`` of JAX's configs) from
    the same weights and batches."""
    cfg, bs, tree = D.fam_case(name, "repro.configs")
    params = jax.tree.map(jnp.asarray, tree)
    bs = [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jbuild(cfg)),
                                         has_aux=True))
    opt_cfg, opt = JAdamW(**D.TP_OPT), j_adamw_init(params)
    metrics, g1 = [], None
    for b in bs:
        (loss, (ce, aux)), g = grad_fn(params, b)
        g1 = g if g1 is None else g1
        params, opt, om = j_adamw_update(opt_cfg, g, opt, params)
        metrics.append({"loss": float(loss), "ce": float(ce),
                        **{k: float(v) for k, v in om.items()}})
    return (metrics, jax.device_get(params), jax.device_get(opt.mu),
            jax.device_get(g1))


@pytest.fixture(scope="module")
def jax_runs(started):
    """{arch or variant: _jax_steps}."""
    return {name: _jax_steps(name)
            for name in list(D.FAM_ARCHS) + list(VARIANT_WORLDS)}


@pytest.fixture(scope="module")
def worlds(started, jax_runs):
    """{world: every rank's {"fam": {name: tp_steps}, ...}}."""
    return {k: D.join(w, JOIN_S) for k, w in started.items()}


def _arch(name):
    return name.split("/")[-1]


def _pairs(a, b):
    """[(path, a leaf, b leaf)] of two trees of JAX's layout (numpy)."""
    return [(p, np.asarray(x, np.float32), np.asarray(y, np.float32))
            for (p, x), (_, y) in zip(leaves_with_paths(a),
                                      leaves_with_paths(b))]


def _check_weights(want, got, g1, w_atol, steps=D.TP_STEPS):
    lr = D.TP_OPT["lr"]
    for (path, a, b), (_, g, _) in zip(_pairs(want, got), _pairs(g1, got)):
        d = np.abs(a - b)
        g = np.abs(g)
        sure = g > 1e-3 * g.max()
        assert (d[sure] <= w_atol).all(), (path, d[sure].max())
        assert (d <= 2 * lr * steps).all(), (path, d.max())


def _check_jax(run, jax_run, arch):
    jm, jp, jmu, g1 = jax_run
    assert run["step"] == D.TP_STEPS
    for want, got in zip(jm, run["metrics"]):
        for k, rtol in (("loss", 2e-6), ("ce", 2e-6),
                        ("grad_norm", JAX_GNORM_RTOL.get(arch, 1e-5)),
                        ("lr", 1e-6)):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)
    _check_weights(jp, run["params"], g1, 5e-5)
    for path, a, b in _pairs(jmu, run["mu"]):
        np.testing.assert_allclose(
            b, a, rtol=1e-4, atol=MU_ATOL.get(arch, 1e-5) * np.abs(a).max(),
            err_msg=path)


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("arch", D.FAM_ARCHS)
def test_partitioned_steps_match_jax(worlds, jax_runs, arch, world):
    """Three float32 steps of each smoke config, its state placed on the
    world's mesh, against jitted JAX's from the same weights: every rank's
    metrics, final weights and first moments."""
    for rank in worlds[world]:
        _check_jax(rank["fam"][arch], jax_runs[arch], arch)


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("arch", D.FAM_ARCHS)
def test_partitioned_steps_match_one_rank(worlds, jax_runs, arch, world):
    """The same steps against the port's on a world of one rank (one
    card's numbers): float32 round-off apart (``TP1_RTOL``,
    ``GNORM_TP1_RTOL``); the ranks of a world agree bit for bit."""
    base = worlds["1x1"][0]["fam"][arch]
    first = worlds[world][0]["fam"][arch]
    for rank in worlds[world]:
        r = rank["fam"][arch]
        for want, got in zip(base["metrics"], r["metrics"]):
            for k, rtol in (("loss", TP1_RTOL["loss"]),
                            ("ce", TP1_RTOL["loss"]),
                            ("grad_norm", GNORM_TP1_RTOL[arch])):
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           err_msg=k)
            assert got["lr"] == want["lr"]
        _check_weights(base["params"], r["params"], jax_runs[arch][3],
                       TP1_RTOL["w"])
        assert r["metrics"] == first["metrics"]
        for _, a, b in _pairs(first["params"], r["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(VARIANT_WORLDS))
def test_variants_match_jax(worlds, jax_runs, name):
    """Each variant's three float32 steps against JAX's jitted steps of the
    same config, weights and batches, at the tolerances above: the gates
    wider than a rank's share, context-parallel attention (cross-attention
    included), the padded vocabulary's mask on the last rank's block, T
    45 (the whole stream; whisper's encoder still cut) and 30 image
    patches over several ranks' blocks."""
    for rank in worlds[VARIANT_WORLDS[name]]:
        _check_jax(rank["fam"][name], jax_runs[name], _arch(name))


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("arch", D.FAM_ARCHS)
def test_blocks_have_jax_shard_shapes(worlds, arch, world):
    """Each rank holds only its blocks: every parameter leaf at
    ``NamedSharding(mesh, param_specs).shard_shape`` and every moment at
    that of ``zero_specs``, JAX's specs on an abstract mesh of the world's
    shape; the projections cut at every model size here."""
    n, model = WORLDS[world]
    mesh = AbstractMesh((n // model, model), ("data", "model"))
    cfg = D.fam_case(arch, "repro.configs")[0]
    shapes = jax.eval_shape(jbuild(cfg).init_params, jax.random.PRNGKey(0))
    pspecs = JS.param_specs(shapes, model_divisor=model)
    zspecs = JS.zero_specs(pspecs, shapes, mesh)

    def want(specs):
        return jax.tree.map(
            lambda s, x: NamedSharding(mesh, s).shard_shape(x.shape),
            specs, shapes,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    wp, wz = want(pspecs), want(zspecs)
    for rank in worlds[world]:
        got_p, got_mu = rank["fam"][arch]["local"]
        for (path, a), (_, b) in zip(leaves_with_paths(wp),
                                     leaves_with_paths(got_p)):
            assert tuple(a) == tuple(b), path
        for (path, a), (_, b) in zip(leaves_with_paths(wz),
                                     leaves_with_paths(got_mu)):
            assert tuple(a) == tuple(b), path
    got = worlds[world][0]["fam"][arch]["local"][0]
    D_, F_ = cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        assert got["blocks"]["tm"]["wr"][2] == D_ // model
        assert got["blocks"]["cm"]["wv"][1] == F_ // model
    elif cfg.family == "hybrid":
        assert got["layers"][0]["rec"]["wx"][1] == cfg.lru_width // model
    elif cfg.family == "audio":
        assert got["dec_layers"][0]["cross_attn"]["wk"][1] == D_ // model
    assert got["embed"][0] * model == D.fam_case(arch)[2]["embed"].shape[0]


def _stacks(cfg, T):
    """[(layers, positions)] of the remat blocks a step runs: whisper's
    encoder (its frames) and decoder, else the model's layers."""
    if cfg.family == "audio":
        return [(cfg.num_encoder_layers, cfg.encoder_positions),
                (cfg.num_layers, T)]
    return [(cfg.num_layers, T)]


@pytest.mark.parametrize("world", list(WORLDS))
def test_sequence_parallel_saves_a_block_of_each_input(worlds, world):
    """The bytes of the remat blocks' inputs a rank saves for the backward
    in step 1 (tests/torch_dist.py ``SavedBlockInputs``): each stack's
    [B / data, T, D] float32 input a layer, cut by sequence to exactly 1
    / model where the axis divides its T (JAX's ``residual_shard``), whole
    where it does not (T 45; whisper's 16 frames still cut)."""
    n, model = WORLDS[world]
    for rank in worlds[world]:
        runs = rank["fam"]
        assert set(D.FAM_ARCHS) <= set(runs)
        for name, r in runs.items():
            cfg, bs, _ = D.fam_case(name)
            want = sum(L * D.TP_B // (n // model) * t * cfg.d_model * 4
                       // (model if t % model == 0 else 1)
                       for L, t in _stacks(cfg, bs[0]["tokens"].shape[1]))
            assert tuple(r["saved"]) == (want, sum(
                L for L, _ in _stacks(cfg, 0))), name


def test_every_arch_takes_the_partitioned_step(worlds):
    """A placed state of every arch of ``configs.ARCHS`` (its smoke
    config, one step on the 1 x 1 host mesh) runs the partitioned step."""
    from repro_torch.configs import ARCHS

    route = worlds["1x1"][0]["route"]
    assert list(route) == list(ARCHS)
    assert all(route.values()), route


def test_loss_tells_a_whole_padded_vocabulary_from_a_block(monkeypatch):
    """make_loss_fn under a model axis takes logits as the rank's block of
    a cut vocabulary only where their width is not the whole logits':
    whisper's whole logits are its padded vocabulary (500 -> 512 here),
    wider than ``vocab_size``, and stay whole where the axis does not
    divide the padded rows (a model of 3), so the CE is the plain one."""
    from repro_torch.distributed import sharding as S
    from repro_torch.models import ModelBundle
    from repro_torch.models.whisper import padded_vocab
    from repro_torch.train import cross_entropy
    from repro_torch.train.step import make_loss_fn

    cfg = dataclasses.replace(D.fam_case("whisper-small")[0], vocab_size=500)
    pv = padded_vocab(cfg)
    assert pv == 512 and pv % 3
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((2, 8, pv), np.float32))
    logits[..., cfg.vocab_size:] = -1e30
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    bundle = ModelBundle(cfg=cfg, init_params=None, init_decode_state=None,
                         state_kwarg="caches",
                         forward=lambda p, t, **kw: (logits, None,
                                                     torch.zeros(())))
    monkeypatch.setattr(S, "model_axis",
                        lambda: S.ModelAxis(group=None, size=3, rank=0))
    loss, (ce, _) = make_loss_fn(bundle)({}, {"tokens": labels,
                                              "labels": labels})
    assert torch.equal(ce, cross_entropy(logits, labels))
