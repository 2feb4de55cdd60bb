"""repro_torch.learn and the engine's observation hook against the JAX
package's ``repro.learn`` on the CPU, with seeded numpy inputs.

Tolerances, and why:

* Observations are bit-equal to JAX's observed step run op by op under
  ``jax.disable_jit()`` (the port follows JAX's op-by-op float32
  semantics; jitted XLA fuses ops, ROADMAP queue 3).
* Features: rtol 1e-6 of JAX's — XLA's CPU ``log1p`` / ``log10`` are
  other routines than PyTorch's, and JAX's teacher capture is jitted.
* Logits: 1e-5 of the largest |logit| of each row — the port sums each
  layer in the kernel's order (sequentially over inputs), JAX's XLA dot in
  its own, and XLA's CPU ``tanh`` is its own approximation.  Actions are
  held equal wherever JAX's top-two logit margin in every head exceeds
  1e-5 of the row's largest |logit|; rows below are near ties, counted and
  printed.
* Learned runs against jitted JAX: ``completed`` / ``time_s`` exact and
  energy to rtol 1e-5, on cells whose smallest relative margin over their
  controller ticks exceeds 1e-5 (a cell below is reported as a near tie).
* Training: ``torch`` draws other numbers than ``jax.random``, so the
  trainers are held to the reference's own acceptance metrics (BC within
  1.10x of the teacher's energy; REINFORCE lowers its cost) and to bit
  determinism per seed.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import learn as jlearn
from repro.api import scenario as jscenario
from repro.core import types as jtypes
from repro_torch import api as tapi
from repro_torch import learn as tlearn
from repro_torch.api import scenario as tscenario
from repro_torch.core import engine as tengine
from repro_torch.core import types as ttypes
from repro_torch.learn.controller import LearnedController
from torch_parity import jax_observed_op_by_op, port_scenario

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from benchmarks import fig2  # noqa: E402

CPU = torch.device("cpu")
MARGIN = 1e-5          # near tie: top-two margin <= MARGIN * max |logit|
FEATURE_RTOL = 1e-6
LOGIT_TOL = 1e-5       # of each row's largest |logit|

FAST = (("a", 200, 400.0, 2.0), ("b", 10, 600.0, 60.0))
ONE = (("c", 50, 500.0, 10.0),)
_DATASETS = {"fast": FAST, "one": ONE}
# tests/test_executors.py GOLDEN_SUBSET
GOLDEN_SUBSET = [("chameleon", "eemt", "fast"), ("chameleon", "me", "fast"),
                 ("chameleon", "wget/curl", "one"),
                 ("cloudlab", "eett", "one")]


def _jax_scenario(pn, ctrl, dn, **kw):
    if isinstance(ctrl, str):
        ctrl = japi.make_controller(
            ctrl, **({"target_tput_mbps": 400.0} if ctrl == "eett" else {}))
    kw.setdefault("total_s", 240.0)
    return japi.Scenario(profile=jtypes.TESTBEDS[pn],
                         datasets=tuple(jtypes.DatasetSpec(*d)
                                        for d in _DATASETS[dn]),
                         controller=ctrl, dt=0.1, **kw)


def _jax_params(seed=0, cfg=jlearn.PolicyConfig()):
    return {k: np.array(v) for k, v in
            jlearn.init_policy(cfg, jax.random.PRNGKey(seed)).items()}


def _margins(logits):
    """Each row's smallest top-two margin over its heads, relative to the
    row's largest |logit| ([..., heads, classes] -> [...])."""
    top = np.sort(logits, axis=-1)
    gap = (top[..., -1] - top[..., -2]).min(axis=-1)
    return gap / np.maximum(np.abs(logits).max(axis=(-1, -2)), 1e-30)


# ------------------------------------------------- observation hook ---------

def _port_runner(sc, observe):
    prepared, groups = tscenario._prepare_groups([sc], CPU)
    (k, idxs), = groups.items()
    runner = tengine.get_runner(k.ctrl_code, k.env_code, k.cpu, k.n_steps,
                                k.dt, k.ctrl_every, "reference",
                                observe=observe)
    return runner(tscenario._stack_group(prepared, idxs, CPU))


def test_runner_arity_with_and_without_observe():
    sc = port_scenario(_jax_scenario("chameleon", "eemt", "fast"))
    assert len(_port_runner(sc, False)) == 3
    out = _port_runner(sc, True)
    assert len(out) == 4 and isinstance(out[3], tengine.Observation)
    assert out[3].avg_tput.shape == out[2].tput_mbps.shape
    assert [o.dtype for o in out[3]] == list(tengine.OBS_DTYPES)
    r = tengine.resolve_executor
    assert r("auto", "cuda", observe=True) == "reference"
    assert r("auto", "cpu", observe=True) == "reference"
    assert r("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="observe=True"):
        r("cuda", "cuda", observe=True)
    with pytest.raises(ValueError, match="observe=True"):
        tengine.build_core(None, None, None, n_steps=1, dt=0.1,
                           ctrl_every=1, executor="cuda", observe=True)


@pytest.mark.parametrize("cell", [("chameleon", "eemt", "fast"),
                                  ("cloudlab", "me", "one")])
def test_observed_runner_bit_identical_to_unobserved(cell):
    sc = port_scenario(_jax_scenario(*cell))
    (sim0, ts0, m0), (sim1, ts1, m1, _) = (_port_runner(sc, False),
                                           _port_runner(sc, True))
    for a, b in zip([*sim0, *ts0, *m0], [*sim1, *ts1, *m1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", GOLDEN_SUBSET)
def test_observation_equals_jax_op_by_op(cell):
    jsc = _jax_scenario(*cell)
    want = jax_observed_op_by_op(jscenario._prepare(jsc))
    run, = tlearn.run_observed([port_scenario(jsc)], device=CPU)
    for field, got, w in zip(tengine.Observation._fields, run.obs, want):
        assert got.shape == w.shape and got.dtype == w.dtype, field
        assert np.array_equal(got, w), field
    # the semantics of repro.learn's own test
    live, ctrl = run.obs.live, run.obs.is_ctrl
    assert not ctrl[~live].any()
    for d in (run.obs.d_num_ch, run.obs.d_cores, run.obs.d_freq_idx):
        assert not d[~ctrl].any()
    for leaf in run.obs:
        assert not leaf[~live].any()
    assert (ctrl.sum() == 0) == (cell[1] == "wget/curl")


def test_teacher_dataset_requires_ctrl_ticks():
    with pytest.raises(ValueError, match="controller tick"):
        tlearn.teacher_dataset(
            [port_scenario(_jax_scenario("chameleon", "wget/curl", "fast"))],
            device=CPU)
    assert tlearn.n_ctrl_ticks(1200, 10) == 120
    assert tlearn.n_ctrl_ticks(5, 10) == 1


# ------------------------------------------------- teacher capture ----------

@pytest.fixture(scope="module")
def teacher():
    """The fig2 smoke cells of the tuners (benchmarks/fig2.py --smoke:
    Chameleon x small/mixed x ME, EEMT at 900 s; its wget/curl cells have
    no controller tick) captured by both packages; JAX's observations too,
    for harvested features."""
    jcells = [c.scenario for c in fig2.experiment(smoke=True).cells()
              if c.labels["tool"] != "wget/curl"]
    jf, jl = jlearn.teacher_dataset(jcells)
    tf, tl = tlearn.teacher_dataset([port_scenario(s) for s in jcells],
                                    device=CPU)
    jruns = jlearn.run_observed(jcells)
    return jcells, (jf, jl), (tf, tl), jruns


def test_teacher_dataset_matches_jax(teacher):
    _, (jf, jl), (tf, tl), _ = teacher
    assert tf.shape == jf.shape and tf.dtype == np.float32
    assert tl.dtype == np.int32
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tf, jf, rtol=FEATURE_RTOL, atol=0)
    assert ((tl >= 0) & (tl < tlearn.N_CLASSES)).all()


def _random_observations(rng, n):
    cpu = ttypes.CpuProfile()
    return dict(avg_tput=rng.uniform(0, 2500, n).astype(np.float32),
                avg_power=rng.uniform(0, 90, n).astype(np.float32),
                cpu_load=rng.uniform(0, 1, n).astype(np.float32),
                remaining_mb=np.where(rng.random(n) < 0.1, 0.0,
                                      rng.uniform(0, 1e5, n))
                .astype(np.float32),
                num_ch=rng.integers(1, 129, n).astype(np.float32),
                cores=rng.integers(1, cpu.num_cores + 1, n).astype(np.int32),
                freq_idx=rng.integers(0, len(cpu.freq_levels_ghz), n)
                .astype(np.int32))


def _nets(rng, n):
    bw = rng.choice([125.0, 1250.0, 500.0, 37.5], n).astype(np.float32)
    max_ch = rng.choice([16.0, 64.0, 128.0], n).astype(np.float32)
    target = rng.uniform(0, 3000, n).astype(np.float32)
    net = jtypes.NetParams(bw, *[np.zeros(n, np.float32)] * 5)
    sla = jtypes.SLAParams(target, *[np.zeros(n, np.float32)] * 3, max_ch,
                           *[np.zeros(n, np.float32)] * 2)
    return net, sla


def _jax_features(obs, net, sla):
    return np.asarray(jlearn.featurize(
        obs["avg_tput"], obs["avg_power"], obs["cpu_load"],
        obs["remaining_mb"], obs["num_ch"], obs["cores"], obs["freq_idx"],
        net=net, sla=sla, cpu=jtypes.CpuProfile()))


def _port_features(obs, net, sla):
    t = {k: torch.as_tensor(v) for k, v in obs.items()}
    return tlearn.featurize(
        t["avg_tput"], t["avg_power"], t["cpu_load"], t["remaining_mb"],
        t["num_ch"], t["cores"], t["freq_idx"],
        net=ttypes.NetParams(*[torch.as_tensor(x) for x in net]),
        sla=ttypes.SLAParams(*[torch.as_tensor(x) for x in sla]),
        cpu=ttypes.CpuProfile()).numpy()


def _harvested(teacher):
    """Every live tick's observation of JAX's teacher runs, with its
    run's net/sla rows."""
    _, _, _, jruns = teacher
    cols = {k: [] for k in ("avg_tput", "avg_power", "cpu_load",
                            "remaining_mb", "num_ch", "cores", "freq_idx")}
    nets, slas = [], []
    for run in jruns:
        live = np.asarray(run.obs.live, bool)
        for k in cols:
            cols[k].append(np.asarray(getattr(run.obs, k))[live])
        nets.append(np.repeat(np.asarray(run.prep.inputs.net)[None],
                              live.sum(), 0))
        slas.append(np.repeat(np.asarray(run.prep.inputs.sla)[None],
                              live.sum(), 0))
    obs = {k: np.concatenate(v) for k, v in cols.items()}
    net = jtypes.NetParams(*np.concatenate(nets).T.astype(np.float32))
    sla = jtypes.SLAParams(*np.concatenate(slas).T.astype(np.float32))
    return obs, net, sla


@pytest.mark.parametrize("source", ["harvested", "random"])
def test_featurize_matches_jax(teacher, source):
    if source == "harvested":
        obs, net, sla = _harvested(teacher)
    else:
        rng = np.random.default_rng(0)
        obs = _random_observations(rng, 4096)
        net, sla = _nets(rng, 4096)
    want = _jax_features(obs, net, sla)
    got = _port_features(obs, net, sla)
    assert got.shape == want.shape == (len(obs["avg_tput"]), 9)
    np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL, atol=0)


@pytest.fixture(scope="module")
def jax_bc_params(teacher):
    _, (jf, jl), _, _ = teacher
    params, _ = jlearn.bc_train(jf, jl, key=jlearn.seed_everything(0),
                                steps=400)
    return {k: np.array(v) for k, v in params.items()}


@pytest.mark.parametrize("params", ["bc", "seed0", "seed1-x4"])
@pytest.mark.parametrize("source", ["harvested", "random"])
def test_apply_policy_and_actions_match_jax(teacher, jax_bc_params, params,
                                            source):
    p = {"bc": jax_bc_params, "seed0": _jax_params(0),
         "seed1-x4": {k: 4 * v for k, v in _jax_params(1).items()}}[params]
    if source == "harvested":
        obs, net, sla = _harvested(teacher)
        feats = np.array(_jax_features(obs, net, sla))
    else:
        feats = np.random.default_rng(1).uniform(
            -0.5, 2.5, (4096, 9)).astype(np.float32)
    cfg = jlearn.PolicyConfig()
    want = np.asarray(jlearn.apply_policy(cfg, p, jnp.asarray(feats)))
    got = tlearn.apply_policy(tlearn.PolicyConfig(), p,
                              torch.as_tensor(feats)).numpy()
    assert got.shape == want.shape == (len(feats), 3, 3)
    scale = np.abs(want).max(axis=(-1, -2))
    err = np.abs(got - want).max(axis=(-1, -2))
    assert (err <= LOGIT_TOL * scale).all(), float((err / scale).max())
    clear = _margins(want) > MARGIN
    near = int((~clear).sum())
    print(f"apply_policy {params}/{source}: {len(feats)} rows, max logit "
          f"err {float((err / scale).max()):.2e} of the row's largest, "
          f"{near} near ties (margin <= {MARGIN})")
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_apply_action_and_action_classes_match_jax():
    rng = np.random.default_rng(2)
    n = 2048
    obs = _random_observations(rng, n)
    _, sla = _nets(rng, n)
    sla = sla._replace(delta_ch=rng.choice([1.0, 2.0, 8.0], n)
                       .astype(np.float32))
    cls = rng.integers(0, 3, (n, 3)).astype(np.int32)
    want = jlearn.apply_action(obs["num_ch"], obs["cores"], obs["freq_idx"],
                               cls, sla=sla, cpu=jtypes.CpuProfile())
    got = tlearn.apply_action(
        torch.as_tensor(obs["num_ch"]), torch.as_tensor(obs["cores"]),
        torch.as_tensor(obs["freq_idx"]), torch.as_tensor(cls),
        sla=ttypes.SLAParams(*[torch.as_tensor(x) for x in sla]),
        cpu=ttypes.CpuProfile())
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    deltas = (rng.normal(size=n).astype(np.float32) * 3,
              rng.integers(-2, 3, n).astype(np.int32),
              rng.integers(-2, 3, n).astype(np.int32))
    deltas[0][:5] = 0.0
    np.testing.assert_array_equal(
        tlearn.action_classes(*[torch.as_tensor(d) for d in deltas]).numpy(),
        np.asarray(jlearn.action_classes(*deltas)))


def test_config_and_init():
    cfg = tlearn.PolicyConfig(hidden=(16, 8))
    params = tlearn.init_policy(cfg, torch.Generator().manual_seed(3))
    assert tlearn.config_from_params(params) == cfg
    assert tlearn.config_from_params(_jax_params(3)) == \
        tlearn.PolicyConfig()
    again = tlearn.init_policy(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert all(not params[k].any() for k in params if k.startswith("b"))
    with pytest.raises(ValueError, match="output dim"):
        tlearn.config_from_params({"w0": np.zeros((9, 4)),
                                   "b0": np.zeros(4)})


# --------------------------------------------- registry & content hash ------

def test_params_digest_equals_jax():
    for seed in (0, 1):
        p = _jax_params(seed)
        assert tlearn.params_digest(p) == jlearn.params_digest(p)
        assert LearnedController(params=p).digest == \
            jlearn.LearnedController(params=p).digest
    torch_params = {k: torch.as_tensor(v) for k, v in _jax_params(0).items()}
    assert LearnedController(params=torch_params).digest == \
        jlearn.params_digest(_jax_params(0))


def test_checkpoints_load_across_the_packages(tmp_path):
    p = _jax_params(5)
    jlearn.save_policy(str(tmp_path / "jax"), p, step=3)
    loaded = tlearn.load_policy(str(tmp_path / "jax"))
    assert sorted(loaded) == sorted(p)
    for k in p:
        assert np.array_equal(loaded[k], p[k]) and loaded[k].dtype == np.float32
    tlearn.save_policy(str(tmp_path / "port"), p, step=7)
    back = jlearn.load_policy(str(tmp_path / "port"))
    assert all(np.array_equal(back[k], p[k]) for k in p)
    assert tapi.make_controller("learned", params=str(tmp_path / "port")) \
        == LearnedController(params=p)
    with pytest.raises(FileNotFoundError):
        tlearn.load_policy(str(tmp_path / "nope"))


def test_registry_roundtrip_and_content_hash():
    assert "learned" in tapi.list_controllers()
    p = _jax_params(1)
    c = tapi.make_controller("learned", params=p)
    assert isinstance(c, LearnedController) and c.name == "learned"
    assert tapi.as_controller(c) is c
    assert tapi.make_controller("learned", params=p) == c
    copied = {k: np.array(v, copy=True) for k, v in p.items()}
    assert hash(LearnedController(params=copied)) == hash(c)
    perturbed = dict(copied, b0=copied["b0"] + 1e-3)
    assert LearnedController(params=perturbed) != c

    def sc(ctrl):
        return port_scenario(_jax_scenario("chameleon", "eemt", "fast"),
                             controller=ctrl)

    assert tapi.scenario_key(sc(c)) == tapi.scenario_key(
        sc(LearnedController(params=copied)))
    assert tapi.group_count([sc(c), sc(LearnedController(params=copied))],
                            device="cpu") == 1
    assert tapi.group_count([sc(c), sc(LearnedController(
        params=perturbed))], device="cpu") == 2
    # the same policy is the same cell in both packages
    jsc = _jax_scenario("chameleon", jlearn.LearnedController(params=p),
                        "fast")
    assert tapi.scenario_key(port_scenario(jsc)) == japi.scenario_key(jsc)
    lab = tapi.make_controller("learned", params=p, timeout_s=2.0,
                               label="bc-v1")
    assert lab.name == "bc-v1" and lab.timeout_s == 2.0
    assert lab.code().sla == ttypes.SLA() and lab.code().digest == c.digest
    # params=None: the port's own deterministic seed-0 policy
    assert LearnedController() == LearnedController()


def test_learned_through_run_and_sweep():
    c = LearnedController()
    scs = [port_scenario(_jax_scenario("chameleon", "eemt", dn),
                         controller=c) for dn in ("fast", "one")]
    solo = [tapi.run(sc, device=CPU) for sc in scs]
    for r in solo:
        assert np.isfinite(r.energy_j) and r.energy_j > 0
    for a, b in zip(solo, tapi.sweep(scs, device=CPU)):
        assert (a.time_s, a.energy_j, a.completed) == \
            (b.time_s, b.energy_j, b.completed)
        for x, y in zip(a.metrics, b.metrics):
            assert np.array_equal(x, y)


def _jax_cell_margin(jsc):
    """The smallest relative top-two margin of JAX's logits over the
    controller ticks of a learned run (jitted, observed)."""
    run, = jlearn.run_observed([jsc])
    ctrl = jsc.controller
    obs = run.obs
    mask = np.asarray(obs.is_ctrl, bool)
    feats = jlearn.featurize(obs.avg_tput, obs.avg_power, obs.cpu_load,
                             obs.remaining_mb, obs.num_ch, obs.cores,
                             obs.freq_idx, net=run.prep.inputs.net,
                             sla=run.prep.inputs.sla, cpu=jsc.cpu)
    logits = np.asarray(jlearn.apply_policy(ctrl.cfg, ctrl.params,
                                            jnp.asarray(feats)))[mask]
    if not mask.any():
        return float("inf"), 0
    return float(_margins(logits).min()), int(mask.sum())


@pytest.mark.parametrize("cell", GOLDEN_SUBSET)
def test_learned_runs_match_jitted_jax(cell):
    """JAX's seed-0 policy on each GOLDEN_SUBSET cell's testbed and data."""
    pn, _, dn = cell
    jctrl = jlearn.LearnedController(params=_jax_params(0))
    jsc = _jax_scenario(pn, jctrl, dn)
    want = japi.run(jsc)
    got = tapi.run(port_scenario(jsc), device=CPU)
    margin, ticks = _jax_cell_margin(jsc)
    print(f"learned {pn}/{dn}: {ticks} controller ticks, smallest margin "
          f"{margin:.3e} of the largest |logit|")
    assert margin > MARGIN, f"near tie on {cell}: margin {margin}"
    assert (got.completed, got.time_s) == (want.completed, want.time_s)
    for f in ("energy_j", "avg_tput_MBps"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=0, err_msg=f)


# ---------------------------------------------------------- trainers --------

def _tiny_dataset():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(128, tlearn.N_FEATURES)).astype(np.float32)
    labels = rng.integers(0, tlearn.N_CLASSES,
                          size=(128, tlearn.N_HEADS)).astype(np.int32)
    return feats, labels


def test_bc_train_is_bit_deterministic_per_seed():
    feats, labels = _tiny_dataset()

    def fit(seed):
        return tlearn.bc_train(feats, labels,
                               key=tlearn.seed_everything(seed), steps=20,
                               device=CPU)

    (p1, h1), (p2, h2), (p3, _) = fit(7), fit(7), fit(8)
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    assert np.array_equal(h1["loss"], h2["loss"]) and h1["loss"].shape == (20,)
    assert not all(np.array_equal(p1[k], p3[k]) for k in p1)
    assert all(v.dtype == np.float32 for v in p1.values())


def test_learn_smoke_bc_fits_teacher_ticks():
    """repro.learn's CI contract: 8 lanes x 64 ticks of EEMT teacher
    rollouts -> a BC fit whose loss decreases, deployable by name."""
    scs = [tapi.Scenario(profile=ttypes.CHAMELEON,
                         datasets=(ttypes.DatasetSpec(
                             "d", 500, 4000.0 + 700.0 * i, 8.0),),
                         controller=tapi.make_controller("eemt"),
                         total_s=6.4, dt=0.1) for i in range(8)]
    feats, labels = tlearn.teacher_dataset(scs, device=CPU)
    assert feats.shape[0] >= 8
    params, hist = tlearn.bc_train(feats, labels,
                                   key=tlearn.seed_everything(0), steps=60,
                                   device=CPU)
    assert hist["loss"][-5:].mean() < hist["loss"][:5].mean()
    c = tapi.make_controller("learned", params=params)
    sc = port_scenario(_jax_scenario("chameleon", "eemt", "one"),
                       controller=c)
    assert tapi.run(sc, device=CPU).energy_j > 0


def test_bc_policy_within_10pct_of_teacher_energy():
    """repro.learn's acceptance test, on the port: behavior cloning EEMT on
    the fig2 smoke cells lands within 10% of the teacher's energy on every
    cell, and both complete."""
    teacher = tapi.make_controller("EEMT", max_ch=64)
    cells = [tapi.Scenario(profile=ttypes.CHAMELEON, datasets=ds,
                           controller=teacher, total_s=900.0, dt=0.1)
             for ds in ((ttypes.SMALL_FILES,), ttypes.MIXED)]
    feats, labels = tlearn.teacher_dataset(cells, device=CPU)
    params, _ = tlearn.bc_train(feats, labels, key=tlearn.seed_everything(0),
                                steps=400, device=CPU)
    learned = LearnedController(params=params, sla=teacher.sla)
    report = tlearn.evaluate(learned, rivals={"EEMT": teacher}, smoke=True,
                             timing="cold", device=CPU)
    ratios = tlearn.vs_teacher(report, "EEMT")
    print(f"BC vs EEMT: {ratios}")
    assert set(ratios) == {"chameleon/small", "chameleon/mixed"}
    for cell, r in ratios.items():
        assert r["learned_completed"] and r["teacher_completed"], cell
        assert r["energy_ratio"] <= 1.10, (cell, r)


def test_pg_train_is_bit_deterministic():
    scs = [tapi.Scenario(profile=ttypes.CHAMELEON,
                         datasets=(ttypes.DatasetSpec(
                             "d", 200, 2000.0 + 500.0 * i, 8.0),),
                         controller=tapi.make_controller("eemt"),
                         total_s=12.0, dt=0.1) for i in range(2)]
    pg = tlearn.PGConfig(steps=2, lr=1e-3)
    p1, h1 = tlearn.pg_train(scs, key=tlearn.seed_everything(3), pg=pg,
                             device=CPU)
    p2, h2 = tlearn.pg_train(scs, key=tlearn.seed_everything(3), pg=pg,
                             device=CPU)
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    assert np.array_equal(h1["cost"], h2["cost"])


def test_pg_train_improves_energy_delay():
    """repro.learn's REINFORCE acceptance configuration: 8 lanes x 120 s,
    ME's starting point, 6 updates; the cost drops below the first
    update's."""
    scs = [tapi.Scenario(profile=ttypes.CHAMELEON,
                         datasets=(ttypes.DatasetSpec(
                             "d", 1000, 8000.0 + 1500.0 * i, 8.0),),
                         controller=tapi.make_controller("eemt"),
                         total_s=120.0, dt=0.1) for i in range(8)]
    pg = tlearn.PGConfig(steps=6, lr=2e-3, tput_floor_mbps=400.0)
    params, hist = tlearn.pg_train(
        scs, key=tlearn.seed_everything(0),
        sla=ttypes.SLA(policy=ttypes.SLAPolicy.MIN_ENERGY), pg=pg,
        device=CPU)
    print(f"PG cost per update: {hist['cost'].tolist()}")
    assert hist["cost"].shape == (6,) and hist["ed_ref"] > 0
    assert hist["cost"].min() < hist["cost"][0]
    assert all(np.isfinite(v).all() for v in params.values())


def test_pg_rejects_mixed_lane_groups():
    scs = [port_scenario(_jax_scenario("chameleon", "eemt", "fast",
                                       total_s=t)) for t in (12.0, 24.0)]
    with pytest.raises(ValueError, match="code group"):
        tlearn.pg_train(scs, key=tlearn.seed_everything(0),
                        pg=tlearn.PGConfig(steps=1), device=CPU)


# -------------------------------------------------------- evaluation --------

@pytest.mark.parametrize("smoke", [True, False])
def test_evaluation_experiment_equals_jax(smoke):
    from repro_torch.api import experiments as texp

    p = _jax_params(0)
    t = tlearn.evaluation_experiment(LearnedController(params=p),
                                     smoke=smoke)
    j = jlearn.evaluation_experiment(jlearn.LearnedController(params=p),
                                     smoke=smoke)
    assert t.name == "learn_eval"
    assert [a.name for a in texp._iter_axes(t.space)] == \
        ["testbed", "dataset", "tool"]
    tools = next(a for a in texp._iter_axes(t.space) if a.name == "tool")
    assert list(tools.labels) == ["learned", "ME", "EEMT", "EETT",
                                  "wget/curl"]
    assert [(c.labels, c.key) for c in t.cells()] == \
        [(c.labels, c.key) for c in j.cells()]
    assert len(t.cells()) == (10 if smoke else 20)
    assert tapi.group_count([c.scenario for c in t.cells()],
                            device="cpu") == 5
    assert dataclasses.asdict(tlearn.PGConfig()) == \
        dataclasses.asdict(jlearn.PGConfig())
