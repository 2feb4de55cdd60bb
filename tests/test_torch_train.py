"""The port's training step against the JAX package's, on the CPU at smoke
widths: ``cross_entropy``, the loss and its gradients, and three jitted
``make_train_step`` steps from a converted JAX train state, in float32 (and
bf16 to a looser tolerance).  The dense family (qwen3, qwen2, olmo-1b's
non-parametric LayerNorm, yi-9b's untied head), the hybrid
one (recurrentgemma-smoke: 6 layers rglru, rglru, local; window 16, so T
48 runs the window mask; its layers a list of dicts of two kinds), whose
RG-LRU runs ``RGLRUScan`` and whose attention ``FlashAttention``, and the
ssm one (rwkv6-smoke), whose WKV recurrence runs the ``WKV`` Function,
here their plain versions (JAX differentiates its associative scan and its
``lax.scan``).

Tolerances, from the readings these tests take (float32 agrees to ~3e-7
in the loss and ~1e-5 in the weights; recurrentgemma ~8e-8 in the loss,
~1.1e-6 in the grad norm, ~3.7e-5 in the weights after 3 steps):
  * loss and ce: rtol 2e-6; grad_norm: rtol 1e-5; lr: rtol 1e-6;
  * gradients: per leaf, atol 1e-5 x the leaf's largest |g| + rtol 1e-4;
    the first Adam moment after three steps the same (rwkv6: see
    ``MU_ATOL``);
  * weights: atol 5e-5 where |g| at step 1 exceeds 1e-3 x the leaf's
    largest |g|.  Adam's first step is sign-like (g / |g|), so a weight
    whose gradient is near 0 may move by up to 2 lr per step the other way:
    everywhere else the bound is 2 lr x steps.
  * bf16 (JAX rounds attention scores and probabilities to bf16, the port's
    kernel keeps them in float32; ROADMAP queue 3): loss rtol 1e-4,
    grad_norm rtol 5e-3, weights within 2^-7 relative + 2 lr x steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config
from repro.models import build as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.train import cross_entropy as j_cross_entropy
from repro.train import init_train_state as j_init
from repro.train import make_loss_fn as j_make_loss_fn
from repro.train import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import SyntheticSource, batches
from repro_torch.models import build as tbuild
from repro_torch.models.layers import SAVED_DOTS
from repro_torch.optim import AdamWConfig
from repro_torch.tree import leaves as tleaves
from repro_torch.train import (cross_entropy, make_loss_fn, make_train_step)
from repro_torch.tree import unflatten_like

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: The first Adam moment after three steps, atol as a share of the leaf's
#: largest |mu| where an arch needs more than 1e-5.  rwkv6-smoke reads
#: 2.8e-5 (recurrentgemma 8.4e-6; tests/torch_goldens/
#: measure_rwkv6_conditioning.py smoke): at equal weights each step's
#: gradient agrees with JAX's to 6e-6 of the leaf's largest, as
#: recurrentgemma's (4.7e-6), but four weights whose step-1 gradient is
#: ~1e-8 (Adam's eps, 1e-6 of their leaf's largest; the two packages'
#: float32 sums differ there by ~20%) take unequal first steps, up to
#: 4.6e-5 apart, and steps 2 and 3 see those weights.
MU_ATOL = {"rwkv6-7b": 5e-5}


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(t_get_smoke_config(arch), dtype=dtype, **kw))


def _states(cfg, tcfg):
    js = j_init(jbuild(cfg), jax.random.PRNGKey(0))
    return js, convert.train_state_from_jax(jax.device_get(js), tcfg, "cpu")


def _batches(vocab, n, batch=4, seq=48):
    it = batches(SyntheticSource(vocab, 4096), batch=batch, seq=seq,
                 tuned=False)
    return [next(it) for _ in range(n)]


def _jnp(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _key(k):
    """A JAX path entry's dict key or list index."""
    return k.idx if hasattr(k, "idx") else k.key


def _leaf_pairs(jtree, ttree):
    """[(path, jax leaf as float32 numpy, port leaf as float32 numpy)]."""
    out = []
    for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        b = ttree
        for k in path:
            b = b[_key(k)]
        out.append(("/".join(str(_key(k)) for k in path),
                    np.asarray(a, np.float32), b.detach().float().numpy()))
    return out


def _check_weights(jparams, tparams, grads1, steps, dtype):
    lr = OPT["lr"]
    for (path, a, b), (_, g, _) in zip(_leaf_pairs(jparams, tparams),
                                       _leaf_pairs(grads1, tparams)):
        d = np.abs(a - b)
        if dtype == "bfloat16":
            assert (d <= 2 ** -7 * np.abs(a) + 2 * lr * steps).all(), (
                path, d.max())
            continue
        g = np.abs(g)
        sure = g > 1e-3 * g.max()
        assert (d[sure] <= 5e-5).all(), (path, d[sure].max())
        assert (d <= 2 * lr * steps).all(), (path, d.max())


# ------------------------------------------------------- cross-entropy ---

@pytest.mark.parametrize("T", [40, 700, 1100])
def test_cross_entropy_matches_jax(T):
    """T < 512 (one chunk), T > 512 not a multiple of it (the last chunk
    takes the remainder), and three chunks; a tenth of the labels
    masked (< 0).  Value and gradient."""
    rng = np.random.default_rng(T)
    logits = rng.standard_normal((2, T, 97), dtype=np.float32) * 3
    labels = rng.integers(0, 97, (2, T)).astype(np.int32)
    labels[rng.random((2, T)) < 0.1] = -1
    jv, jg = jax.value_and_grad(j_cross_entropy)(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    tl = torch.from_numpy(logits).requires_grad_()
    tv = cross_entropy(tl, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tv, tl)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=2e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)
    with torch.no_grad():
        assert float(cross_entropy(tl, torch.from_numpy(labels))) == \
            float(tv.detach())


def test_cross_entropy_of_all_masked_labels_is_zero():
    logits = torch.randn(1, 8, 11)
    assert float(cross_entropy(logits, torch.full((1, 8), -1))) == 0.0


# ----------------------------------------------- loss, grads and steps ---

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-0.5b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "olmo-1b", "yi-9b"])
def test_loss_and_gradients_match_jax(arch):
    cfg, tcfg = _cfgs(arch)
    js, _ = _states(cfg, tcfg)
    b = _batches(cfg.vocab_size, 1)[0]
    (jl, (jce, _)), jg = jax.jit(jax.value_and_grad(
        j_make_loss_fn(jbuild(cfg)), has_aux=True))(js.params, _jnp(b))
    params = convert.lm_params_from_jax(jax.device_get(js.params), tcfg,
                                        "cpu")
    flat = [(p, x.requires_grad_()) for p, x in _flat(params)]
    tl, (tce, _) = make_loss_fn(tbuild(tcfg))(params, b)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-6)
    np.testing.assert_allclose(float(tce.detach()), float(jce), rtol=2e-6)
    grads = torch.autograd.grad(tl, [x for _, x in flat])
    tgrads = _unflat([(p, g) for (p, _), g in zip(flat, grads)])
    for path, a, g in _leaf_pairs(jg, tgrads):
        np.testing.assert_allclose(g, a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(), err_msg=path)


def _flat(tree, prefix=()):
    out = []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out += _flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflat(pairs):
    out = {}
    for path, v in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _run_both(cfg, tcfg, n_steps, microbatches=1):
    js, ts = _states(cfg, tcfg)
    bs = _batches(cfg.vocab_size, n_steps)
    jstep = jax.jit(j_make_train_step(jbuild(cfg), JAdamW(**OPT),
                                      microbatches=microbatches))
    tstep = make_train_step(tbuild(tcfg), AdamWConfig(**OPT),
                            microbatches=microbatches)
    grads1 = jax.jit(jax.grad(lambda p, b: j_make_loss_fn(jbuild(cfg))(
        p, b)[0]))(js.params, _jnp(bs[0]))
    metrics = []
    for b in bs:
        js, jm = jstep(js, _jnp(b))
        ts, tm = tstep(ts, b)
        metrics.append((jm, tm))
    return js, ts, metrics, grads1


def _check_metrics(metrics, dtype="float32"):
    loss_rtol, gn_rtol = (2e-6, 1e-5) if dtype == "float32" else (1e-4,
                                                                  5e-3)
    for jm, tm in metrics:
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=loss_rtol, err_msg=k)
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=gn_rtol)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-0.5b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "olmo-1b", "yi-9b"])
def test_three_train_steps_match_jax(arch):
    """From a converted JAX train state, three steps of the port against
    three jitted JAX steps on the same batches: metrics, weights, Adam
    moments and counters."""
    cfg, tcfg = _cfgs(arch)
    js, ts, metrics, grads1 = _run_both(cfg, tcfg, 3)
    _check_metrics(metrics)
    _check_weights(js.params, ts.params, grads1, 3, "float32")
    for _, a, b in _leaf_pairs(js.opt.mu, ts.opt.mu):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=MU_ATOL.get(
            arch, 1e-5) * np.abs(a).max())
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt.count) == int(js.opt.count) == 3
    assert ts.step.dtype == torch.int32


def test_microbatches_match_jax():
    """microbatches=2: float32 accumulation over two halves, then x 1/2."""
    cfg, tcfg = _cfgs("qwen3-0.6b")
    js, ts, metrics, grads1 = _run_both(cfg, tcfg, 2, microbatches=2)
    _check_metrics(metrics)
    _check_weights(js.params, ts.params, grads1, 2, "float32")


def test_microbatches_equal_one_batch_in_the_port():
    """Two microbatches of a batch give the one-batch loss and gradient
    norm (up to float32 summation order)."""
    _, tcfg = _cfgs("qwen3-0.6b")
    b = _batches(tcfg.vocab_size, 1)[0]
    _, ts = _states(*_cfgs("qwen3-0.6b"))
    out = [make_train_step(tbuild(tcfg), AdamWConfig(**OPT),
                           microbatches=m)(ts, b)[1] for m in (1, 2)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[1][k]), float(out[0][k]),
                                   rtol=1e-5)


def test_remat_on_and_off_give_equal_values():
    """``cfg.remat`` runs each block under torch.utils.checkpoint: the
    recomputation gives the same values bit for bit on the CPU."""
    _check_remat_equal("qwen3-0.6b")


def test_hybrid_remat_on_and_off_give_equal_values():
    """recurrentgemma runs each layer under torch.utils.checkpoint (the
    backward recomputes its RG-LRU scan and attention): the same values."""
    _check_remat_equal("recurrentgemma-2b")


def test_rwkv6_remat_on_and_off_give_equal_values():
    """rwkv6 runs each block under torch.utils.checkpoint (the backward
    recomputes its WKV forward, then runs the WKV Function's backward): the
    same values."""
    _check_remat_equal("rwkv6-7b")


def _check_remat_equal(arch):
    out = []
    for remat in (True, False):
        cfg, tcfg = _cfgs(arch, remat=remat)
        _, ts = _states(cfg, tcfg)
        b = _batches(cfg.vocab_size, 1)[0]
        ts, m = make_train_step(tbuild(tcfg), AdamWConfig(**OPT))(ts, b)
        out.append((m, ts))
    (m1, s1), (m2, s2) = out
    for k in ("loss", "grad_norm"):
        assert float(m1[k]) == float(m2[k])
    for (_, a, b) in _leaf_pairs(jax.tree.map(np.asarray, convert.
                                              train_state_to_jax(s1)["params"]),
                                 s2.params):
        np.testing.assert_array_equal(a, b)


def test_bf16_train_steps_close_to_jax():
    cfg, tcfg = _cfgs("qwen3-0.6b", dtype="bfloat16")
    js, ts, metrics, grads1 = _run_both(cfg, tcfg, 2)
    _check_metrics(metrics, "bfloat16")
    _check_weights(js.params, ts.params, grads1, 2, "bfloat16")
    assert ts.params["embed"].dtype == torch.bfloat16
    assert ts.opt.mu["embed"].dtype == torch.float32


def test_unported_options_raise_and_name_their_item():
    """Nothing is left unported: ``remat_save="dots"`` trains as
    ``"nothing"`` does, bit for bit.  ``grad_acc_specs`` (item 9e.1)
    places the float32 accumulator on the ambient mesh and changes no
    number; without a mesh it raises."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import close_world, make_host_mesh

    _, tcfg = _cfgs("qwen3-0.6b")
    bundle = tbuild(tcfg)
    _, ts = _states(*_cfgs("qwen3-0.6b"))
    b2 = _batches(tcfg.vocab_size, 1)[0]
    plain, pm = make_train_step(bundle, AdamWConfig(), microbatches=2)(ts, b2)
    mesh = make_host_mesh(model=1, device="cpu")
    try:
        specs = sharding.zero_specs(sharding.param_specs(ts.params),
                                    ts.params, mesh)
        step = make_train_step(bundle, AdamWConfig(), microbatches=2,
                               grad_acc_specs=specs)
        with pytest.raises(ValueError, match="set_mesh"):
            step(ts, b2)
        with sharding.set_mesh(mesh):
            placed, qm = step(ts, b2)
    finally:
        close_world()
    assert all(torch.equal(a, b) for a, b in zip(tleaves(plain),
                                                   tleaves(placed)))
    assert all(torch.equal(pm[k], qm[k]) for k in pm)
    # vision_embeds are ported (item 9e's first part): the dense LM takes
    # them as JAX's lm.forward does, in its first slots
    b = dict(_batches(tcfg.vocab_size, 1)[0],
             vision_embeds=torch.zeros(4, 2, tcfg.d_model))
    _, m = make_train_step(bundle, AdamWConfig())(ts, b)
    _, m0 = make_train_step(bundle, AdamWConfig())(
        ts, _batches(tcfg.vocab_size, 1)[0])
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) != float(
        m0["loss"])
    b1 = _batches(tcfg.vocab_size, 1)[0]
    s1, m1 = make_train_step(bundle, AdamWConfig())(ts, b1)
    s2, m2 = make_train_step(tbuild(dataclasses.replace(
        tcfg, remat_save="dots")), AdamWConfig())(ts, b1)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(tleaves(s1.params),
                                                   tleaves(s2.params)))


class _MatmulCount(TorchDispatchMode):
    """Counts the matrix products without batch dims (``aten.mm``,
    ``aten.addmm``) run while entered."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in SAVED_DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "whisper-small"])
def test_dots_remat_keeps_the_products(arch):
    """``remat_save="dots"`` (JAX's ``dots_with_no_batch_dims_saveable``)
    gives ``"nothing"``'s loss and gradients bit for bit, and its backward
    recomputes no product: it runs the ``aten.mm`` of a backward without
    remat, where ``"nothing"`` runs more."""
    base, tcfg = _cfgs(arch)
    out = {}
    for tag, kw in (("nothing", {}), ("dots", dict(remat_save="dots")),
                    ("off", dict(remat=False))):
        bundle = tbuild(dataclasses.replace(tcfg, **kw))
        params = bundle.init_params(0, device="cpu")
        batch = _batches(tcfg.vocab_size, 1, seq=32)[0]
        if tcfg.family == "audio":
            batch["frame_embeds"] = torch.randn(
                4, tcfg.encoder_positions, tcfg.d_model,
                generator=torch.Generator().manual_seed(2))
        req = [p.detach().requires_grad_(True) for p in tleaves(params)]
        with torch.enable_grad():
            loss, _ = make_loss_fn(bundle, "dense" if tcfg.moe else "gmm")(
                unflatten_like(params, req), batch)
            with _MatmulCount() as mm:
                grads = torch.autograd.grad(loss, req)
        out[tag] = (loss, grads, mm.n)
    assert torch.equal(out["nothing"][0], out["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["nothing"][1],
                                                   out["dots"][1]))
    assert out["dots"][2] == out["off"][2] < out["nothing"][2]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_dots_train_steps_match_jax_dots(arch):
    """Two float32 steps with ``remat_save="dots"`` in both packages, to
    test_three_train_steps_match_jax's tolerances."""
    cfg, tcfg = _cfgs(arch, remat_save="dots")
    js, ts, metrics, grads1 = _run_both(cfg, tcfg, 2)
    _check_metrics(metrics)
    _check_weights(js.params, ts.params, grads1, 2, "float32")
