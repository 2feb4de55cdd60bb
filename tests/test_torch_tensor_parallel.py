"""The partitioned train step (``train/step.py``; the tensor-parallel regions
of ``distributed/sharding.py``, ``models/layers.py`` and ``models/lm.py``)
on gloo worlds of the CPU against jitted JAX and the port's own step on
one rank.

The ranks (tests/torch_dist.py ``tp_train``, ``tp_parts``, ``tp_moe``,
``tp_moe_parts``, ``a2a_region``) import no JAX; this process runs JAX
while they run.  Worlds, as (data, model) host meshes: (1, 1), (1, 2),
(1, 4) and (2, 2).  qwen3 smoke at model 4 has 2 key-value heads, so
``wk``/``wv`` are cut into half heads and gathered; the MLP, the attention
and the vocabulary are cut at every model size here.

The MoE family (qwen3-moe smoke, and moonshot smoke with two shared
experts, whose MLP is then 2 x d_ff wide) takes the partitioned step
under ``moe_impl`` gmm and dense: each rank its E / model experts.  At
(1, 2) and (1, 4) it is held against JAX's jitted steps of the same
``moe_impl``; at (2, 2) its data ranks mask unequal shares of their
labels, held against JAX's steps of the loss the step means
(``jax_moe_runs``: the load-balancing term is each data rank's, 1 / 2
each).  Under a2a at ample capacity its steps without a load-balancing
term are JAX's gmm steps, and its term is the mean of the ranks' local
estimates (``jax_a2a_local``); the a2a layer on a rank's blocks is held
to JAX's ``moe_a2a`` under a 2 x 2 mesh (tests/torch_goldens/
moe_a2a.json).

Tolerances, from the readings these tests take:
  * against JAX, test_torch_train's (float32 agrees to ~3e-7 in the loss):
    loss and ce rtol 2e-6, grad_norm rtol 1e-5, lr rtol 1e-6; weights
    atol 5e-5 where |g| at step 1 exceeds 1e-3 x the leaf's largest |g|,
    else 2 lr a step (Adam's first step is sign-like); the first moment
    rtol 1e-4 + atol 1e-5 x the leaf's largest;
  * against the port on one rank (``TP1_RTOL``): the row products summed
    over ranks, the cut cross-entropy and the data mean change only
    float32 round-off (measured at most 1.6e-7 in the loss, 2.0e-7 in the
    grad norm and 4.5e-7 in the sure weights over the 12 cases);
  * the cut cross-entropy against the whole one: rtol 1e-6 (value) and
    1e-5 (gradient), and against JAX's as test_torch_train's.
"""
import base64
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import torch_dist as D
from repro.distributed import sharding as JS
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train import TrainState as JTrainState
from repro.train import cross_entropy as j_cross_entropy
from repro.train import make_loss_fn as j_make_loss_fn
from repro.train import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.optim import global_norm
from repro_torch.train import cross_entropy
from repro_torch.tree import leaves_with_paths

#: name: (ranks, model size); data = ranks / model.
WORLDS = {"1x1": (1, 1), "1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}
TP_WORLDS = ("1x2", "1x4", "2x2")
#: Against the port at one rank: loss and ce, grad_norm (relative), and
#: the weights' largest |difference| where the step-1 gradient is sure
#: (as against JAX).
TP1_RTOL = dict(loss=1e-6, grad_norm=1e-6, w=5e-6)
#: The MoE family's runs: ``arch/moe_impl``.
MOE_RUNS = [f"{a}/{i}" for a in D.TP_MOE_ARCHS for i in D.TP_MOE_IMPLS]
#: The MoE's tp 1 at each world: the same data ranks at model 1 (the
#: load-balancing term is each data rank's).
MOE_TP1 = {"1x2": ("1x1", "moe"), "1x4": ("1x1", "moe"),
           "2x2": ("1x2", "moe_dp2")}
#: Sequence parallelism off against on (the configs' default), and the
#: variants held against jitted JAX with the world they run on
#: (tests/torch_dist.py TP_VARIANTS).
SP_OFF = ["sp_off/qwen3-0.6b", "sp_off/yi-9b"]
T45 = ["t45/qwen2-0.5b", "t45/qwen3-moe-30b-a3b"]
VARIANT_WORLDS = {"cp/qwen3-0.6b": "1x2", "cp6/qwen2-0.5b": "1x4",
                  **{name: "1x2" for name in T45}}
#: The a2a's load-balancing term and the router's gradient against JAX's
#: (its output at ample capacity is gmm's; the term the mean of the ranks'
#: local estimates): rtol, and atol as a share of the largest |gradient|.
A2A_AUX_RTOL, A2A_GRAD_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every world started at once (joined by ``worlds``, after JAX's
    runs, which run meanwhile)."""
    tmp = tmp_path_factory.mktemp("tp")
    var = {"1x1": [],
           "1x2": [["var", "tp_variants", {
               "model": 2, "names": [*SP_OFF, "cp/qwen3-0.6b", *T45],
               "saved": ["sp/qwen3-0.6b", "sp/qwen3-moe-30b-a3b",
                         "t45/qwen2-0.5b"]}]],
           "1x4": [["var", "tp_variants", {
               "model": 4, "names": ["cp6/qwen2-0.5b"],
               "saved": ["sp/qwen3-0.6b", "cp6/qwen2-0.5b"]}]],
           "2x2": [["var", "tp_variants", {
               "model": 2, "names": SP_OFF, "saved": ["sp/qwen3-0.6b"]}]]}
    moe = {"1x1": [["moe", "tp_moe", {"model": 1}]],
           "1x2": [["moe", "tp_moe", {"model": 2}],
                   ["moe_dp2", "tp_moe", {"model": 1, "uneven": True,
                                          "a2a": False}],
                   ["moe_parts", "tp_moe_parts", {"model": 2}]],
           "1x4": [["moe", "tp_moe", {"model": 4}]],
           "2x2": [["moe", "tp_moe", {"model": 2, "uneven": True}],
                   ["a2a_region", "a2a_region", {}]]}
    started = {}
    for name, (n, model) in WORLDS.items():
        parts = [["train", "tp_train", {"model": model}]]
        if model > 1:
            parts.append(["parts", "tp_parts", {"model": model}])
        started[name] = D.start_world("many", n, tmp / name,
                                      parts=parts + moe[name] + var[name])
    return started


@pytest.fixture(scope="module")
def worlds(started, jax_runs, jax_moe_plain, jax_moe_runs, jax_a2a_local,
           jax_variants):
    """{world: every rank's {"train": ..., "parts": ..., "moe": ...}}."""
    return {k: D.join(w) for k, w in started.items()}


def _jax_steps(cfg, bs, moe_impl="gmm", loss_fn=None):
    """(metrics of each step, final params, final mu, step-1 gradients) of
    JAX's steps of ``cfg`` from ``convert.random_lm_params(cfg, 0)``, one
    a batch of ``bs``: jitted ``make_train_step`` of ``moe_impl``, or
    with ``loss_fn(params, batch) -> (loss, (ce, aux))`` its jitted
    gradients and ``adamw_update``."""
    params = jax.tree.map(jnp.asarray, convert.random_lm_params(cfg, 0))
    bundle = jbuild(cfg)
    bs = [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]
    if loss_fn is None:
        loss_fn = j_make_loss_fn(bundle, moe_impl)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    opt_cfg, opt = JAdamW(**D.TP_OPT), j_adamw_init(params)
    metrics, g1 = [], None
    for b in bs:
        (loss, (ce, aux)), g = grad_fn(params, b)
        g1 = g if g1 is None else g1
        params, opt, om = j_adamw_update(opt_cfg, g, opt, params)
        metrics.append({"loss": float(loss), "ce": float(ce),
                        "aux": float(aux),
                        **{k: float(v) for k, v in om.items()}})
    return (metrics, jax.device_get(params), jax.device_get(opt.mu),
            jax.device_get(g1))


@pytest.fixture(scope="module")
def jax_runs(started):
    """{arch: (metrics of each step, final params, final mu, step-1
    gradients)} of jitted JAX from the same weights and batches."""
    out = {}
    for arch in D.TP_ARCHS:
        cfg = D.tp_config(arch, "repro.configs")
        params = jax.tree.map(jnp.asarray, convert.random_lm_params(cfg, 0))
        state = JTrainState(params, j_adamw_init(params),
                            jnp.zeros((), jnp.int32))
        bundle = jbuild(cfg)
        step = jax.jit(j_make_train_step(bundle, JAdamW(**D.TP_OPT)))
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in D.tp_batches(cfg.vocab_size)]
        g1 = jax.jit(jax.grad(lambda p, b: j_make_loss_fn(bundle)(p, b)[0]))(
            params, bs[0])
        metrics = []
        for b in bs:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = (metrics, jax.device_get(state.params),
                     jax.device_get(state.opt.mu), jax.device_get(g1))
    return out


@pytest.fixture(scope="module")
def jax_moe_plain(started):
    """{run: _jax_steps} of JAX's steps of each MoE run on tp_batches (one
    data rank's loss: JAX's own), and ``a2a``: qwen3-moe's gmm steps
    without a load-balancing term."""
    out = {}
    for run in MOE_RUNS:
        arch, impl = run.split("/")
        cfg = D.tp_config(arch, "repro.configs")
        out[run] = _jax_steps(cfg, D.tp_batches(cfg.vocab_size), impl)
    cfg = D.tp_config(D.TP_MOE_ARCH, "repro.configs", load_balance_coef=0.0)
    out["a2a"] = _jax_steps(cfg, D.tp_batches(cfg.vocab_size))
    return out


@pytest.fixture(scope="module")
def jax_moe_runs(started):
    """{run: (metrics of each step, final params, step-1 gradients, step
    1's CE of the whole batch)} of JAX's steps of each MoE run on
    tp_moe_batches with the loss of the partitioned step over two data
    ranks (the batch's first and second halves): the global batch's mean
    CE, each half's weighted by its unmasked labels, plus the mean of the
    halves' load-balancing terms (1 / 2 each; JAX's global batch has one
    term of every token, which a data rank cannot see)."""
    out = {}
    for run in MOE_RUNS:
        arch, impl = run.split("/")
        cfg = D.tp_config(arch, "repro.configs")
        loss_fn = j_make_loss_fn(jbuild(cfg), impl)
        h = D.TP_B // 2

        def ranks_loss(p, b, loss_fn=loss_fn):
            halves = [{k: v[r * h:(r + 1) * h] for k, v in b.items()}
                      for r in range(2)]
            parts = [loss_fn(p, x)[1] for x in halves]
            cs = [jnp.sum(x["labels"] >= 0).astype(jnp.float32)
                  for x in halves]
            ce = (cs[0] * parts[0][0] + cs[1] * parts[1][0]) / (cs[0]
                                                                + cs[1])
            aux = (parts[0][1] + parts[1][1]) / 2
            return ce + aux, (ce, aux)
        bs = D.tp_moe_batches(cfg.vocab_size)
        metrics, params, _, g1 = _jax_steps(cfg, bs, loss_fn=ranks_loss)
        whole = float(jax.jit(loss_fn)(
            jax.tree.map(jnp.asarray, convert.random_lm_params(cfg, 0)),
            {k: jnp.asarray(v) for k, v in bs[0].items()})[1][0])
        out[run] = (metrics, params, g1, whole)
    return out


@pytest.fixture(scope="module")
def jax_variants(started):
    """{variant: _jax_steps} of JAX's jitted steps of each variant held
    against JAX (VARIANT_WORLDS), its config replaced alike
    (``D.tp_variant`` of JAX's configs): ``cp_attention`` is a sharding
    hint to JAX, so its steps are those of the math."""
    return {name: _jax_steps(*D.tp_variant(name, "repro.configs"))
            for name in VARIANT_WORLDS}


@contextlib.contextmanager
def _local_estimates(nd, mp):
    """While entered, JAX's ``moe_gmm`` returns the a2a's load-balancing
    term: the mean of the estimates of the ``nd`` x ``mp`` blocks of its
    tokens (data rank by batch rows, model rank by sequence), its output
    as it is (the a2a's at ample capacity)."""
    real = JL.moe_gmm

    def local(cfg, p, x):
        y, _ = real(cfg, p, x)
        B, T, Dm = x.shape
        b, t = B // nd, T // mp
        auxs = [JL.moe_router(cfg, p, x[i * b:(i + 1) * b, j * t:(j + 1)
                                        * t].reshape(-1, Dm))[2]
                for i in range(nd) for j in range(mp)]
        return y, sum(auxs) / len(auxs)
    JL.moe_gmm = local
    try:
        yield
    finally:
        JL.moe_gmm = real


@pytest.fixture(scope="module")
def jax_a2a_local(started):
    """{world: (step 1's load-balancing term, the router's step-1
    gradient)} of qwen3-moe on tp_batches' first batch with the a2a's
    term at the world's blocks (``_local_estimates``), by jitted JAX."""
    cfg = D.tp_config(D.TP_MOE_ARCH, "repro.configs")
    params = jax.tree.map(jnp.asarray, convert.random_lm_params(cfg, 0))
    b = {k: jnp.asarray(v) for k, v in D.tp_batches(cfg.vocab_size)[0]
         .items()}
    out = {}
    for world, (n, model) in WORLDS.items():
        with _local_estimates(n // model, model):
            (_, (_, aux)), g = jax.jit(jax.value_and_grad(
                j_make_loss_fn(jbuild(cfg)), has_aux=True))(params, b)
        out[world] = (float(aux),
                      np.asarray(g["blocks"]["moe"]["router"]))
    return out


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


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("arch", D.TP_ARCHS)
def test_partitioned_steps_match_jax(worlds, jax_runs, arch, world):
    """Three float32 steps of each dense smoke config, its state placed on
    the world's mesh, against jitted JAX's from the same weights: every
    rank's metrics, final weights and first moments."""
    jm, jp, jmu, g1 = jax_runs[arch]
    for rank in worlds[world]:
        r = rank["train"][arch]
        assert r["step"] == D.TP_STEPS
        for want, got in zip(jm, r["metrics"]):
            for k, rtol in (("loss", 2e-6), ("ce", 2e-6),
                            ("grad_norm", 1e-5), ("lr", 1e-6)):
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           err_msg=k)
        _check_weights(jp, r["params"], g1, 5e-5)
        for path, a, b in _pairs(jmu, r["mu"]):
            np.testing.assert_allclose(b, a, rtol=1e-4,
                                       atol=1e-5 * np.abs(a).max(),
                                       err_msg=path)


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("arch", D.TP_ARCHS)
def test_partitioned_steps_match_one_rank(worlds, jax_runs, arch, world):
    """The same steps against the port's on a world of one rank (a 1 x 1
    mesh, one card's numbers): float32 round-off apart (``TP1_RTOL``);
    the ranks of a world agree bit for bit."""
    base = worlds["1x1"][0]["train"][arch]
    g1 = jax_runs[arch][3]
    first = worlds[world][0]["train"][arch]
    for rank in worlds[world]:
        r = rank["train"][arch]
        for want, got in zip(base["metrics"], r["metrics"]):
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(
                    got[k], want[k], rtol=TP1_RTOL.get(k, TP1_RTOL["loss"]),
                    err_msg=k)
            assert got["lr"] == want["lr"]
        _check_weights(base["params"], r["params"], g1, TP1_RTOL["w"])
        assert r["metrics"] == first["metrics"]
        for _, a, b in _pairs(first["params"], r["params"]):
            np.testing.assert_array_equal(a, b)


def _check_metrics(want_metrics, got_metrics, aux=True):
    """Each step's metrics at test_torch_train's tolerances (aux rtol
    1e-5, where it is compared)."""
    for want, got in zip(want_metrics, got_metrics):
        for k, rtol in (("loss", 2e-6), ("ce", 2e-6), ("aux", 1e-5),
                        ("grad_norm", 1e-5), ("lr", 1e-6)):
            if k != "aux" or aux:
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           err_msg=k)


def test_data_parallel_moe_step_weights_only_the_ce(worlds, jax_moe_runs):
    """qwen3-moe smoke's step under gmm with its state placed on 2 x 2 (the
    partitioned step: each rank its experts), its data ranks masking about
    0.46 and 0.1 of their labels: every rank's metrics and final weights
    are those of JAX's steps of the loss the step means
    (``jax_moe_runs``: the CE weighted by each rank's unmasked labels, the
    load-balancing terms 1 / 2 each), at test_torch_train's tolerances and
    aux rtol 1e-5; step 1's CE is JAX's over the whole batch."""
    jm, jp, g1, whole = jax_moe_runs[f"{D.TP_MOE_ARCH}/gmm"]
    for rank in worlds["2x2"]:
        r = rank["moe"][f"{D.TP_MOE_ARCH}/gmm"]
        assert r["step"] == D.TP_STEPS
        np.testing.assert_allclose(r["metrics"][0]["ce"], whole, rtol=2e-6)
        assert all(want["aux"] > 0 for want in jm)
        _check_metrics(jm, r["metrics"])
        _check_weights(jp, r["params"], g1, 5e-5)


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("run", MOE_RUNS)
def test_moe_partitioned_steps_match_jax(worlds, jax_moe_plain,
                                         jax_moe_runs, run, world):
    """Three float32 steps of each MoE smoke config under gmm and dense,
    the state placed on the world's mesh (each rank its experts, the
    router whole), against JAX's steps of the same ``moe_impl`` from the
    same weights: every rank's metrics, final weights (and at one data
    rank the first moments); at 2 x 2 JAX's steps of the two data ranks'
    loss on unequal masks (``jax_moe_runs``)."""
    if world == "2x2":
        jm, jp, g1, _ = jax_moe_runs[run]
        jmu = None
    else:
        jm, jp, jmu, g1 = jax_moe_plain[run]
    for rank in worlds[world]:
        r = rank["moe"][run]
        assert r["step"] == D.TP_STEPS
        _check_metrics(jm, r["metrics"])
        _check_weights(jp, r["params"], g1, 5e-5)
        for path, a, b in (_pairs(jmu, r["mu"]) if jmu is not None else ()):
            np.testing.assert_allclose(b, a, rtol=1e-4,
                                       atol=1e-5 * np.abs(a).max(),
                                       err_msg=path)


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("run", MOE_RUNS)
def test_moe_partitioned_steps_match_one_rank(worlds, jax_moe_plain,
                                              jax_moe_runs, run, world):
    """The same steps against the port's at model 1 over the same data
    ranks (``MOE_TP1``): float32 round-off apart (``TP1_RTOL``), the
    experts' sums over the model axis included; the ranks of a world
    agree bit for bit."""
    where, part = MOE_TP1[world]
    base = worlds[where][0][part][run]
    g1 = jax_moe_runs[run][2] if world == "2x2" else jax_moe_plain[run][3]
    first = worlds[world][0]["moe"][run]
    for rank in worlds[world]:
        r = rank["moe"][run]
        for want, got in zip(base["metrics"], r["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm"):
                np.testing.assert_allclose(
                    got[k], want[k], rtol=TP1_RTOL.get(k, TP1_RTOL["loss"]),
                    err_msg=k)
            assert got["lr"] == want["lr"]
        _check_weights(base["params"], r["params"], g1, TP1_RTOL["w"])
        assert r["metrics"] == first["metrics"]
        for _, a, b in _pairs(first["params"], r["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("run", MOE_RUNS)
def test_moe_router_gradient_is_tp1s(worlds, run):
    """At (1, 2), the router's step-1 gradient taken in the partitioned
    region (the router run alike on both ranks, the combine weights of
    each rank's experts entering the region) equals tp 1's, to
    ``TP1_RTOL``'s weights' bound of the largest."""
    for rank in worlds["1x2"]:
        g = rank["moe_parts"][run]
        np.testing.assert_allclose(g["region"], g["tp1"], rtol=0,
                                   atol=TP1_RTOL["w"]
                                   * np.abs(g["tp1"]).max())


def test_shared_experts_on_a_ranks_blocks_are_tp1s(worlds):
    """moonshot's two shared experts (one MLP 2 x d_ff wide) on a rank's
    blocks at (1, 2) (d_ff columns each: the width of ``cfg.d_ff``, which
    must not be taken for the whole leaf) give tp 1's output."""
    cfg = D.tp_config("moonshot-v1-16b-a3b")
    width = cfg.moe.d_ff_expert * cfg.moe.num_shared_experts
    for rank in worlds["1x2"]:
        p = rank["moe_parts"]
        assert p["shared_block"] == (width // 2, cfg.d_model) == (
            cfg.d_ff, cfg.d_model)
        np.testing.assert_allclose(p["shared"], p["shared_tp1"], rtol=1e-5,
                                   atol=1e-6 * np.abs(p["shared_tp1"]).max())


@pytest.mark.parametrize("world", list(WORLDS))
def test_a2a_partitioned_steps_match_jax_gmm(worlds, jax_moe_plain, world):
    """qwen3-moe's partitioned step under a2a at ample capacity (nothing
    drops, so the a2a is the dropless gmm) without a load-balancing term
    (the a2a's is the ranks' local estimates, not gmm's global one):
    every rank's metrics and final weights are JAX's gmm steps' (1 x 1:
    the body at model 1, no all-to-all)."""
    jm, jp, jmu, g1 = jax_moe_plain["a2a"]
    for rank in worlds[world]:
        r = rank["moe"]["a2a"]
        assert all(m["aux"] == 0 for m in r["metrics"])
        _check_metrics(jm, r["metrics"], aux=False)
        _check_weights(jp, r["params"], g1, 5e-5)


@pytest.mark.parametrize("world", list(WORLDS))
def test_a2a_load_balance_term_is_the_mean_of_local_estimates(
        worlds, jax_a2a_local, world):
    """The a2a's load-balancing term at step 1 is the mean of the ranks'
    local estimates (JAX's ``pmean`` over the data and model axes:
    ``jax_a2a_local``), and at (1, 2) the router's gradient in the region
    is JAX's gradient of that loss (the term counted once: every model
    rank carries the loss whole)."""
    aux, g_router = jax_a2a_local[world]
    for rank in worlds[world]:
        np.testing.assert_allclose(rank["moe"]["a2a_aux"]["metrics"][0]
                                   ["aux"], aux, rtol=A2A_AUX_RTOL)
    if world == "1x2":
        for rank in worlds[world]:
            np.testing.assert_allclose(
                rank["moe_parts"]["a2a"], g_router, rtol=0,
                atol=A2A_GRAD_ATOL * np.abs(g_router).max())


def _golden(tag):
    with open(os.path.join(os.path.dirname(__file__), "torch_goldens",
                           "moe_a2a.json")) as f:
        return json.load(f)["cases"][tag]


def _f32(s, shape):
    return np.frombuffer(base64.b64decode(s), "<f4").reshape(shape)


@pytest.mark.parametrize("tag", ["ample", "tight", "grad", "t7"])
def test_a2a_layer_on_a_ranks_blocks_is_jax_a2a(worlds, tag):
    """moe_a2a inside a partitioned region of 2 x 2, on each rank's blocks
    (its data rank's rows, its model rank's experts), against JAX's
    moe_a2a under a 2 x 2 mesh (tests/torch_goldens/moe_a2a.json, as
    tests/test_torch_moe_a2a.py holds the global path): the output rows
    to 1e-5, the aux to 1e-6 (tight: tokens dropped by each rank's own
    order), and the gradients of ``sum(y^2) + aux`` (the rank's blocks of
    JAX's) to 1e-5 of the largest."""
    g = _golden(tag)
    B, E = D.MOE["B"], D.MOE["E"]
    for r, rank in enumerate(worlds["2x2"]):
        d, m = divmod(r, 2)
        got = rank["a2a_region"][tag]
        y = got["y"]
        rows = slice(d * y.shape[0], (d + 1) * y.shape[0])
        want = _f32(g["y"], (B,) + y.shape[1:])[rows]
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
        assert abs(float(got["aux"]) - g["aux"]) <= 1e-6
        for name, v in got.get("grads", {}).items():
            if name == "router":
                w = _f32(g["grads"][name], v.shape)
            elif name == "x":
                w = _f32(g["grads"][name], (B,) + v.shape[1:])[rows]
            else:
                n = v.shape[0]
                w = _f32(g["grads"][name], (E,) + v.shape[1:])[
                    m * n:(m + 1) * n]
            np.testing.assert_allclose(v, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{tag} d/d{name}")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("arch", D.TP_ARCHS + D.TP_MOE_ARCHS)
def test_blocks_have_jax_shard_shapes(worlds, arch, world):
    """Each rank holds only its blocks: every parameter leaf at
    ``NamedSharding(mesh, param_specs).shard_shape`` and every moment at
    that of ``zero_specs`` (also cut over 'data'), JAX's specs on an
    abstract mesh of the world's shape; the MoE's experts E / model a
    rank."""
    n, model = WORLDS[world]
    mesh = AbstractMesh((n // model, model), ("data", "model"))
    cfg = D.tp_config(arch, "repro.configs")
    moe = cfg.moe is not None

    def local(rank):
        return (rank["moe"][f"{arch}/gmm"] if moe else
                rank["train"][arch])["local"]
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
        got_p, got_mu = local(rank)
        for (path, a), (_, b) in zip(leaves_with_paths(wp),
                                     leaves_with_paths(got_p)):
            assert tuple(a) == tuple(b), path
        for (path, a), (_, b) in zip(leaves_with_paths(wz),
                                     leaves_with_paths(got_mu)):
            assert tuple(a) == tuple(b), path
    if model > 1:
        # the attention's and the MLP's (or the experts') blocks, the
        # vocabulary's
        got_p = local(worlds[world][0])[0]
        if moe:
            m = cfg.moe
            assert got_p["blocks"]["moe"]["wg"][1] == m.num_experts // model
            assert got_p["blocks"]["moe"]["router"][2] == m.num_experts
            if m.num_shared_experts:
                assert got_p["blocks"]["moe"]["shared"]["wd"][1] == (
                    m.d_ff_expert * m.num_shared_experts // model)
        else:
            assert got_p["blocks"]["mlp"]["wd"][1] == cfg.d_ff // model
        assert got_p["embed"][0] == cfg.vocab_size // model


@pytest.mark.parametrize("T", D.TP_CE_T)
@pytest.mark.parametrize("world", ["1x2", "1x4"])
def test_cross_entropy_over_a_cut_vocabulary(worlds, world, T):
    """Each rank's cross_entropy of its block of the vocabulary (model 2
    and 4; a tenth of the labels masked) equals the whole vocabulary's,
    value and gradient block, and JAX's."""
    logits, labels = D.tp_ce_inputs(T)
    whole = torch.from_numpy(logits).requires_grad_()
    v = cross_entropy(whole, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(v, whole)
    jv = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    n = D.TP_CE_VOCAB // WORLDS[world][1]
    for r, rank in enumerate(worlds[world]):
        got = rank["parts"]["ce"][T]
        np.testing.assert_allclose(got["value"], float(v), rtol=1e-6)
        np.testing.assert_allclose(got["value"], float(jv), rtol=2e-6)
        np.testing.assert_allclose(got["grad"],
                                   g.numpy()[..., r * n:(r + 1) * n],
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("world", TP_WORLDS)
def test_global_norm_over_blocks(worlds, world):
    """global_norm over the blocks of a placed gradient tree (each cut
    leaf's squares summed over 'model', a replicated leaf once) equals the
    norm of the whole tree, on every rank."""
    for rank in worlds[world]:
        p = rank["parts"]
        assert any(p["cut"]) and not all(p["cut"])
        np.testing.assert_allclose(p["norm_blocks"], p["norm_whole"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world", TP_WORLDS)
def test_placed_init_is_the_placed_whole_init(worlds, world):
    """init_train_state(mesh=...) draws as the whole init does and keeps
    each rank's blocks (every family cut leaf by leaf as drawn: stacked
    layers one at a time, recurrentgemma's and whisper's lists layer by
    layer): parameters and moments equal to place_state of the whole
    state, placements and global shapes too, on every rank."""
    for rank in worlds[world]:
        for arch, same in rank["parts"]["init"].items():
            assert same and all(same), arch


@pytest.mark.parametrize("H,Hkv,size", [(4, 2, 4), (16, 8, 16),
                                         (32, 4, 2), (12, 2, 3)])
def test_attention_over_a_ranks_heads(H, Hkv, size):
    """flash_attention(heads=(q_head0, kv_head0, group)) on each rank's
    query heads, with every key-value head, equals those heads of the
    whole attention (GQA by the global head index: a rank's heads within
    one group, several groups, and 12/2 over 3 ranks, whose 4 heads take
    two key-value heads unevenly); the ranks' k and v gradients add up to
    the whole one's."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(H * 100 + size)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 24, h, 16), dtype=np.float32)).requires_grad_()
        for h in (H, Hkv, Hkv, H))
    y = flash_attention(q, k, v)
    gk, gv = torch.autograd.grad(y, (k, v), do)
    n = H // size
    sk, sv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(size):
        sl = slice(r * n, (r + 1) * n)
        yr = flash_attention(q[:, :, sl], k, v, heads=(r * n, 0, H // Hkv))
        torch.testing.assert_close(yr, y[:, :, sl], rtol=1e-6, atol=1e-6)
        a, b = torch.autograd.grad(yr, (k, v), do[:, :, sl])
        sk, sv = sk + a, sv + b
    torch.testing.assert_close(sk, gk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sv, gv, rtol=1e-5, atol=1e-6)


def test_global_norm_without_blocks_is_unchanged():
    """``cut=None`` is the one-card norm, bit for bit."""
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 4),
                                                      dtype=np.float32)),
            "b": [torch.from_numpy(rng.standard_normal(5, dtype=np.float32))]}
    want = torch.sqrt(torch.sum(torch.square(tree["a"]))
                      + torch.sum(torch.square(tree["b"][0])))
    assert torch.equal(global_norm(tree), want)
    assert torch.equal(global_norm(tree, cut=[False, False]), want)


def test_the_port_runs_the_dense_family_partitioned():
    """The dense and MoE families take the partitioned step, as every
    family now does: the step keeps no family list and no data-parallel
    branch (tests/test_torch_tensor_parallel_families.py runs a placed
    state of every arch through it)."""
    from repro_torch.train import step

    assert not hasattr(step, "PARTITIONED_FAMILIES")
    # yi's untied head is cut by vocabulary as the tied embedding is
    assert D.tp_config("yi-9b").tie_embeddings is False


@pytest.mark.parametrize("world", ["1x2", "2x2"])
@pytest.mark.parametrize("name", SP_OFF)
def test_sequence_parallel_steps_match_sp_off(worlds, jax_runs, name,
                                              world):
    """The partitioned steps with the residual stream cut by sequence (the
    configs' default: every case above runs it) against the same steps
    with ``seq_parallel`` off, on the same world: float32 round-off apart
    (``TP1_RTOL``: the sums over the model axis are reduce-scatters of
    the same partial sums in place of all-reduces)."""
    arch = name.split("/")[1]
    g1 = jax_runs[arch][3]
    for rank in worlds[world]:
        on, off = rank["train"][arch], rank["var"][name]
        for want, got in zip(off["metrics"], on["metrics"]):
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(
                    got[k], want[k], rtol=TP1_RTOL.get(k, TP1_RTOL["loss"]),
                    err_msg=k)
            assert got["lr"] == want["lr"]
        _check_weights(off["params"], on["params"], g1, TP1_RTOL["w"])


@pytest.mark.parametrize("name", list(VARIANT_WORLDS))
def test_context_parallel_and_undivided_steps_match_jax(worlds, jax_variants,
                                                        name):
    """Three float32 steps of each variant against JAX's jitted steps of
    the same config, at the dense tests' tolerances (metrics, weights,
    first moments): context-parallel attention at (1, 2) by
    ``cp_attention`` and at (1, 4) where the 6 heads do not divide the
    axis (every head on the rank's block of the queries, at query offset
    rank x T / model, K and V gathered); and at T 45, which the model
    axis does not divide, the whole stream (the dense and the MoE)."""
    jm, jp, jmu, g1 = jax_variants[name]
    for rank in worlds[VARIANT_WORLDS[name]]:
        r = rank["var"][name]
        assert r["step"] == D.TP_STEPS
        _check_metrics(jm, r["metrics"])
        _check_weights(jp, r["params"], g1, 5e-5)
        for path, a, b in _pairs(jmu, r["mu"]):
            np.testing.assert_allclose(b, a, rtol=1e-4,
                                       atol=1e-5 * np.abs(a).max(),
                                       err_msg=path)


@pytest.mark.parametrize("world", TP_WORLDS)
def test_sequence_parallel_saves_a_block_of_each_input(worlds, world):
    """The bytes of the remat blocks' inputs a rank saves for the backward
    (``saved_tensors_hooks``, tests/torch_dist.py ``SavedBlockInputs``):
    with the stream whole, every layer's [B / data, T, D] float32 input;
    cut by sequence, exactly 1 / model of that (the dense and the MoE,
    and context-parallel attention at (1, 4)); at T 45, which the axis
    does not divide, the whole."""
    n, model = WORLDS[world]
    for rank in worlds[world]:
        saved = rank["var"]["saved"]
        assert saved
        for name, got in saved.items():
            cfg, bs, _ = D.tp_variant(name)
            T = bs[0]["tokens"].shape[1]
            whole = (cfg.num_layers * D.TP_B // (n // model) * T
                     * cfg.d_model * 4)
            assert tuple(got["off"]) == (whole, cfg.num_layers), name
            if T % model:
                assert tuple(got["sp"]) == tuple(got["off"]), name
            else:
                assert got["sp"][0] * model == whole, name
                assert got["sp"][1] == cfg.num_layers, name
