"""The CUDA kernels on the card (``gpu`` marker; skipped without one): the
tick loop (reference physics, every environment family, the learned
controller), flash
attention forward (hd 64, 128 and 256) and backward, each by both routes
(bf16: wgmma; float32: FMA), the WKV recurrence and its backward, and the
RG-LRU scan and its backward, each against its plain version.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py tears down through the JAX package.)
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import scenario as S
from repro_torch.core import engine, tickstate
from repro_torch.core import types
from repro_torch.kernels import tick_loop as tl
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bhtd,
                                                 flash_attention_bwd_bhtd)
from repro_torch.kernels.rglru import (rglru, rglru_bwd_ref, rglru_ref,
                                       rglru_scan, rglru_scan_bwd)
from repro_torch.kernels.rwkv6 import (wkv, wkv_bhtd, wkv_bwd_bhtd,
                                       wkv_bwd_ref, wkv_ref)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  (RUN_GOLDEN and its scenarios)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _random_scenarios(rng, n):
    """Random transfers over every controller kind and P = 1..8."""
    out = []
    names = ["EEMT", "ME", "EETT", "ismail-target", "wget/curl", "http/2",
             "ismail-max-tput", "ismail-min-energy"]
    for k in range(n):
        p = int(rng.integers(1, 9))
        ds = tuple(types.DatasetSpec(f"d{j}", int(rng.integers(1, 5000)),
                                     float(rng.uniform(1, 3000)),
                                     float(rng.uniform(0.01, 300)))
                   for j in range(p))
        prof = types.NetworkProfile(
            "r", float(rng.uniform(50, 2000)), float(rng.uniform(0.005, 0.1)),
            float(rng.uniform(0.3, 8)), float(rng.uniform(0.5, 16)),
            float(rng.uniform(1.0, 2.0)), float(rng.uniform(0, 0.4)))
        name = names[k % len(names)]
        kw = {}
        if name in ("EEMT", "ME", "EETT"):
            kw = dict(alpha=float(rng.uniform(0, 0.3)),
                      beta=float(rng.uniform(0, 0.3)),
                      delta_ch=int(rng.integers(1, 8)),
                      max_ch=int(rng.integers(2, 129)),
                      scaling=bool(k % 16 < 8))
        if name in ("EETT", "ismail-target"):
            kw["target_tput_mbps"] = float(rng.uniform(0, 1500))
        bw = np.repeat(rng.uniform(0.2, 1.1, 10).astype(np.float32), 60)
        out.append(api.Scenario(profile=prof, datasets=ds,
                                controller=api.make_controller(name, **kw),
                                total_s=60.0, dt=0.1, bw_schedule=bw))
    return out


@pytest.mark.gpu
def test_kernel_bit_exact_vs_plain_version_on_the_card(cuda_device):
    scs = list(chip_smoke.golden_scenarios().values())
    scs += _random_scenarios(np.random.default_rng(0), 96)
    prepared, groups = S._prepare_groups(scs, cuda_device)
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, cuda_device)
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        args = (key.ctrl_code, key.env_code, key.cpu, prow, inp.bw, f0, i0)
        kw = dict(dt=key.dt, ctrl_every=key.ctrl_every)
        before = tl.tick_loop.launches
        a = tl.tick_loop(*args, **kw)
        torch.cuda.synchronize()
        assert tl.tick_loop.launches == before + 1
        b = tl.tick_loop_reference(*args, **kw)
        for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
            assert torch.equal(x, y), key


@pytest.mark.gpu
def test_grouped_kernel_one_launch_per_sweep_on_the_card(cuda_device):
    """A sweep of many groups (every controller kind, P 1..8, the
    reference and two other environments) is one launch per partition
    count among its groups; every group equals the plain version on the
    group alone bit for bit, final rows and seven traces
    (``tick_loop.launches`` counts launches, not groups)."""
    import dataclasses

    envs = [None, chip_smoke.env_smoke_environments()["dvfs hp race"],
            chip_smoke.env_smoke_environments()["big-little"]]
    scs = [dataclasses.replace(sc, environment=envs[k % 3], executor="cuda")
           for k, sc in enumerate(_random_scenarios(
               np.random.default_rng(1), 48))]
    n_groups = api.group_count(scs)
    assert 2 <= n_groups <= tl.MAX_GROUPS
    before = tl.tick_loop.launches
    prepared, runs = api.run_groups(scs)
    torch.cuda.synchronize()
    _, groups = S._prepare_groups(scs, cuda_device)
    n_p = len({key.n_partitions for key in groups})
    assert tl.tick_loop.launches == before + n_p and len(runs) == n_groups
    for run in runs:
        inp = S._stack_group(prepared, groups[run.key], cuda_device)
        prow, f0, i0 = engine.pack_batch(run.key.env_code, inp)
        f32, i32, m = tl.tick_loop_reference(
            run.key.ctrl_code, run.key.env_code, run.key.cpu, prow, inp.bw,
            f0, i0, dt=run.key.dt, ctrl_every=run.key.ctrl_every)
        lay = tickstate.TickLayout(run.key.n_partitions)
        got = (*lay.pack_state(run.sim, run.ts), *run.metrics)
        want = (f32, i32, *m._replace(done=m.done != 0))
        for x, y in zip(got, want):
            assert torch.equal(x, y), run.key


@pytest.mark.gpu
def test_run_golden_on_the_card(cuda_device):
    before = tl.tick_loop.launches
    for cell, sc in chip_smoke.golden_scenarios().items():
        r = api.run(sc)                       # auto -> the cuda executor
        assert (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
                r.avg_power_w) == chip_smoke.RUN_GOLDEN[cell], cell
    assert tl.tick_loop.launches == before + len(chip_smoke.RUN_GOLDEN)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(chip_smoke.env_smoke_environments()))
def test_environment_kernel_bit_exact_vs_plain_version_on_the_card(
        cuda_device, name):
    """chip_smoke.py phase 17b at one P and one controller: EEMT on
    Chameleon x MIXED (P 3) for 120 s, final rows and traces bit-equal."""
    sc = api.Scenario(profile=types.CHAMELEON, datasets=types.MIXED,
                      controller=api.make_controller("EEMT", max_ch=64),
                      environment=chip_smoke.env_smoke_environments()[name],
                      total_s=120.0, executor="cuda")
    (key, rows), = chip_smoke.groups_on_card([sc], cuda_device)
    before = tl.tick_loop.launches
    a = chip_smoke.call(tl.tick_loop, key, rows)
    torch.cuda.synchronize()
    assert tl.tick_loop.launches == before + 1
    b = chip_smoke.call(tl.tick_loop_reference, key, rows)
    for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert torch.equal(x, y), name


@pytest.mark.gpu
def test_environment_degenerations_on_the_card(cuda_device):
    """The four degenerate environments reproduce RUN_GOLDEN through
    ``api.run`` on the card (auto -> the cuda executor), a launch each."""
    cases = chip_smoke.degeneration_scenarios()
    before = tl.tick_loop.launches
    for (cell, en), sc in cases:
        r = api.run(sc)
        assert (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
                r.avg_power_w) == chip_smoke.RUN_GOLDEN[cell], (cell, en)
    assert tl.tick_loop.launches == before + len(cases)


def _learned_controllers():
    """JAX's BC policy (tests/torch_goldens/learn_full.json) and a seeded
    numpy policy of 4 layers whose heads move often."""
    from repro_torch.learn import LearnedController

    params, _ = chip_smoke.golden_learned()
    rng = np.random.default_rng(0)
    sizes = (9, 16, 64, 24, 9)
    deep = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        deep[f"w{i}"] = (rng.normal(size=(n_in, n_out)) * 3.0
                         / np.sqrt(n_in)).astype(np.float32)
        deep[f"b{i}"] = (rng.normal(size=n_out) * 0.1).astype(np.float32)
    return {"jax-bc": LearnedController(params=params, sla=types.SLA(
        max_ch=64)), "deep": LearnedController(params=deep)}


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["jax-bc", "deep"])
@pytest.mark.parametrize("env", ["reference", "dvfs hp race"])
def test_learned_kernel_bit_exact_vs_plain_version_on_the_card(
        cuda_device, policy, env):
    """chip_smoke.py phase 18b: a learned controller on Chameleon x small
    and mixed (900 s) and on the tune lanes of one bandwidth schedule,
    kernel == plain version bit for bit; ``api.run`` launches the kernel
    once."""
    import dataclasses

    ctrl = _learned_controllers()[policy]
    environment = (None if env == "reference" else
                   chip_smoke.env_smoke_environments()[env])
    scs = [dataclasses.replace(sc, controller=ctrl, environment=environment,
                               executor="cuda")
           for sc in chip_smoke.learn_teacher_cells()]
    tune = [dataclasses.replace(sc, environment=environment, executor="cuda")
            for sc in chip_smoke.tune_scenarios(
                learned=ctrl.params)[::len(chip_smoke.TUNE_SEEDS)]]
    for group in (scs, tune):
        (key, rows), = chip_smoke.groups_on_card(group, cuda_device)
        before = tl.tick_loop.launches
        a = chip_smoke.call(tl.tick_loop, key, rows)
        torch.cuda.synchronize()
        assert tl.tick_loop.launches == before + 1
        b = chip_smoke.call(tl.tick_loop_reference, key, rows)
        for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
            assert torch.equal(x, y), (policy, env)
        assert int(a[1][:, 0].max()) >= 2     # controller ticks ran
    before = tl.tick_loop.launches
    r = api.run(dataclasses.replace(scs[1], executor="auto"))
    assert tl.tick_loop.launches == before + 1 and r.energy_j > 0


ROUTE = {torch.float32: "fma", torch.bfloat16: "wgmma"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd", [(16, 8, 128), (14, 2, 64),
                                      (10, 1, 256)])
def test_flash_attention_kernel_vs_plain_version_on_the_card(cuda_device,
                                                             dtype, H, Hkv,
                                                             hd):
    """Kernel == plain version within 2e-5 (float32) / 2e-2 (bf16), as in
    tests/test_kernels.py, on [B,T,H,hd] views; o keeps q's strides.  bf16
    runs the wgmma kernel, float32 the FMA kernel.  Ragged T, Tq != Tk,
    windows, non-causal, with and without LSE; the last case reads k and v
    as views of a longer cache whose slots past Tk hold NaN (the kernels
    must stop at the view, not at the storage)."""
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(0)
    for B, Tq, Tk, causal, window, lse, extra in [
            (1, 128, 128, True, 0, False, 0), (2, 384, 384, False, 0, True, 0),
            (2, 200, 200, True, 64, True, 0),
            (1, 1000, 1000, True, 0, False, 0),
            (3, 70, 130, True, 0, True, 0), (3, 130, 70, True, 0, True, 0),
            (2, 150, 150, True, 0, True, 100)]:
        q = torch.randn(B, Tq, H, hd, generator=g).to(cuda_device, dtype)
        cache = [torch.full((B, Tk + extra, Hkv, hd), float("nan"),
                            device=cuda_device, dtype=dtype)
                 for _ in range(2)]
        for c in cache:
            c[:, :Tk] = torch.randn(B, Tk, Hkv, hd, generator=g).to(
                cuda_device, dtype)
        args = [q.transpose(1, 2)] + [c[:, :Tk].transpose(1, 2)
                                      for c in cache]
        kw = dict(causal=causal, window=window, return_lse=lse)
        before = flash_attention_bhtd.launches
        by_route = flash_attention_bhtd.route_launches[ROUTE[dtype]]
        got = flash_attention_bhtd(*args, **kw)
        torch.cuda.synchronize()
        assert flash_attention_bhtd.launches == before + 1
        assert flash_attention_bhtd.route_launches[ROUTE[dtype]] == \
            by_route + 1
        want = attention_ref(*args, **kw)
        if not lse:
            got, want = (got,), (want,)
        assert got[0].transpose(1, 2).is_contiguous()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert bool(torch.isfinite(a).all())
            err = float((a.float() - b.float()).abs().max())
            assert err <= tol, (B, Tq, Tk, causal, window, extra, err)


def _bwd_close(a, b, dtype):
    """float32: |a - b| <= 5e-5 + 5e-5 |b| element-wise, the reference's own
    bound (tests/test_kernels.py:181-182, assert_allclose with atol = rtol
    = 5e-5); bf16: within 2e-2 of the gradient's largest magnitude (one
    rounding of each output to bf16, a relative 2^-8, plus float32 sums in
    another order).  Returns (ok, max |a - b|)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    if dtype == torch.float32:
        ok = bool((diff <= 5e-5 + 5e-5 * b.abs()).all())
    else:
        ok = float(diff.max()) <= 2e-2 * float(b.abs().max())
    return ok, float(diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd", [(16, 8, 128), (14, 2, 64),
                                      (10, 1, 256)])
def test_flash_attention_bwd_kernel_vs_plain_version_on_the_card(
        cuda_device, dtype, H, Hkv, hd):
    """Backward kernel == plain version from the same o and lse, within
    :func:`_bwd_close`.  Ragged T, Tq != Tk, windows and non-causal cases;
    launch count by route; then the autograd Function."""
    g = torch.Generator().manual_seed(1)
    for B, Tq, Tk, causal, window in [
            (1, 128, 128, True, 0), (2, 200, 200, True, 64),
            (1, 256, 256, False, 0), (2, 1000, 1000, True, 0),
            (1, 384, 384, False, 128), (3, 70, 130, True, 0)]:
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(
            cuda_device, dtype).transpose(1, 2)
            for h, T in ((H, Tq), (Hkv, Tk), (Hkv, Tk), (H, Tq))]
        o, lse = flash_attention_bhtd(q, k, v, causal=causal, window=window,
                                      return_lse=True)
        before = flash_attention_bwd_bhtd.launches
        by_route = flash_attention_bwd_bhtd.route_launches[ROUTE[dtype]]
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        assert flash_attention_bwd_bhtd.launches == before + 1
        assert flash_attention_bwd_bhtd.route_launches[ROUTE[dtype]] == \
            by_route + 1
        want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            ok, err = _bwd_close(a, b, dtype)
            assert ok, (B, Tq, Tk, causal, window, err)
    x = [torch.randn(2, 256, h, hd, generator=g).to(cuda_device, dtype)
         .requires_grad_() for h in (H, Hkv, Hkv)]
    out = {}
    for ex in ("cuda", "reference"):
        o = flash_attention(*x, executor=ex)
        out[ex] = torch.autograd.grad(o, x, torch.ones_like(o))
    for a, b in zip(out["cuda"], out["reference"]):
        ok, err = _bwd_close(a, b, dtype)
        assert ok, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic_on_the_card(cuda_device,
                                                         dtype):
    """Two backward runs on the same inputs give bit-equal dq, dk, dv: no
    atomics, every output element written once (GQA 16/8 and 14/2, MQA
    10/1 at hd 256)."""
    g = torch.Generator().manual_seed(4)
    for B, T, H, Hkv, hd in [(2, 1000, 16, 8, 128), (1, 512, 14, 2, 64),
                             (2, 1000, 10, 1, 256)]:
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(
            cuda_device, dtype).transpose(1, 2) for h in (H, Hkv, Hkv, H)]
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True)
        first = flash_attention_bwd_bhtd(q, k, v, o, lse, do)
        second = flash_attention_bwd_bhtd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def _forced(module, attr, plan):
    """Context: ``module.attr`` (a route or path planner) forced to return
    ``plan(*its arguments)``; None keeps the wrapper's own."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = getattr(module, attr)
        if plan is not None:
            setattr(module, attr, lambda *a: plan(orig, *a))
        try:
            yield
        finally:
            setattr(module, attr, orig)
    return ctx()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_wkv_kernel_vs_plain_version_on_the_card(cuda_device, dtype,
                                                 w_dtype):
    """Kernel 4 == plain version on [B,T,H,64] views, from zero and from a
    state: y within 1e-4 (float32) / 1e-2 (bf16) of its largest |value|
    (float32 sums in another order, FMA contraction; one bf16 rounding of
    y), S_final within 1e-4 of its largest |value|.  bf16 runs on both
    routes (the chunked and the step kernel, the other one forced), at T
    about a chunk of 64 and at the extreme decays exp(-exp(-8)) and
    exp(-exp(3))."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    g = torch.Generator().manual_seed(2)
    for B, T, H, with_s0, x_range in [
            (1, 1, 3, True, None), (2, 200, 4, False, None),
            (1, 64, 2, True, None), (3, 17, 1, True, None),
            (2, 63, 2, True, None), (2, 65, 2, False, None),
            (1, 150, 2, True, (-8.0, -8.0)), (1, 150, 2, True, (3.0, 3.0)),
            (2, 300, 3, True, (-8.0, 3.0))]:
        r, k, v = [(torch.randn(B, T, H, 64, generator=g) * 0.5).to(
            cuda_device, dtype).transpose(1, 2) for _ in range(3)]
        if x_range is None:
            w = torch.rand(B, T, H, 64, generator=g) * 0.5 + 0.45
        else:
            w = torch.exp(-torch.exp(x_range[0] + (x_range[1] - x_range[0])
                                     * torch.rand(B, T, H, 64, generator=g)))
        w = w.to(cuda_device, w_dtype).transpose(1, 2)
        u = (torch.randn(H, 64, generator=g) * 0.3).to(cuda_device)
        S0 = ((torch.randn(B, H, 64, 64, generator=g) * 0.2).to(cuda_device)
              if with_s0 else None)
        yr, Sr = wkv_ref(r, k, v, w, u, S0)
        own = mod.wkv_plan(r, k, v, w, torch.empty_like(r), 132)[0]
        plans = [None]
        if dtype == torch.bfloat16:
            plans.append((lambda orig, *a: ("step", 64)) if own == "chunk"
                         else (lambda orig, *a: ("chunk", 32)))
        for plan in plans:
            before = wkv_bhtd.launches
            with _forced(mod, "wkv_plan", plan):
                y, S = wkv_bhtd(r, k, v, w, u, S0)
            torch.cuda.synchronize()
            assert wkv_bhtd.launches == before + 1
            assert y.dtype == yr.dtype and y.transpose(1, 2).is_contiguous()
            ytol = 1e-4 if dtype == torch.float32 else 1e-2
            where = (B, T, H, x_range, own, plan is not None)
            assert float((y.float() - yr.float()).abs().max()) <= \
                ytol * max(1.0, float(yr.float().abs().max())), where
            assert float((S - Sr).abs().max()) <= \
                1e-4 * max(1.0, float(Sr.abs().max())), where


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_wkv_bwd_kernel_vs_plain_version_on_the_card(cuda_device, dtype,
                                                     w_dtype):
    """The WKV backward == wkv_bwd_ref on [B,T,H,64] views (heads sliced
    out of a wider tensor), S0 and dS_final zero or given, T about the
    64-step chunks and their sub-chunks, decays over exp(-exp(x)), x in
    [-8, 3]: outputs in bf16 within 1e-2 of their largest |value| (one
    rounding), float32 ones within 1e-4 (sums in another order, FMA
    contraction, the chunked route's bf16 high + low operand split); one
    wrapper launch a call, on its plan's route, and every bf16 case again
    on the other route.  Under autograd ``wkv`` runs both kernels and its
    gradients stand as close to the ``reference`` executor's."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    g = torch.Generator().manual_seed(4)
    for B, T, H, with_s0, with_ds in [
            (1, 1, 2, False, True), (2, 63, 2, True, False),
            (1, 64, 3, True, True), (2, 65, 1, False, False),
            (1, 200, 2, True, True), (1, 1000, 1, True, False)]:
        def draw(scale=0.5):
            x = torch.randn(B, T, 2 * H, 64, generator=g) * scale
            return x.to(cuda_device, dtype).transpose(1, 2)[:, H:]
        r, k, v, dy = draw(), draw(), draw(), draw(1.0)
        x = -8.0 + 11.0 * torch.rand(B, T, 2 * H, 64, generator=g)
        w = torch.exp(-torch.exp(x)).to(cuda_device, w_dtype).transpose(
            1, 2)[:, H:]
        u = (torch.randn(H, 64, generator=g) * 0.5).to(cuda_device)
        S0, dS = ((torch.randn(B, H, 64, 64, generator=g) * 0.2).to(
            cuda_device) if on else None for on in (with_s0, with_ds))
        want = wkv_bwd_ref(r, k, v, w, u, S0, dy, dS)
        own = mod.wkv_bwd_plan(r, k, v, w, dy, 132)[0]
        assert own == ("chunk" if dtype == torch.bfloat16 and T >= 64
                       else "step")
        plans = [None]
        if dtype == torch.bfloat16:
            plans.append((lambda orig, *a: ("step", 64)) if own == "chunk"
                         else (lambda orig, *a: ("chunk", 32)))
        for plan in plans:
            route = own if plan is None else plan(None)[0]
            before = dict(wkv_bwd_bhtd.route_launches)
            with _forced(mod, "wkv_bwd_plan", plan):
                got = wkv_bwd_bhtd(r, k, v, w, u, S0, dy, dS)
            torch.cuda.synchronize()
            assert wkv_bwd_bhtd.route_launches[route] == before[route] + 1
            for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dS0"),
                                  got, want):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                tol = 1e-4 if a.dtype == torch.float32 else 1e-2
                assert float((a.float() - b.float()).abs().max()) <= \
                    tol * max(1.0, float(b.float().abs().max())), \
                    (name, B, T, H, route)
    leaves = [t.transpose(1, 2).detach().requires_grad_()
              for t in (r, k, v, w)] + [u.requires_grad_()]
    out = {}
    for ex in ("cuda", "reference"):
        y, _ = wkv(*leaves, executor=ex)
        out[ex] = torch.autograd.grad(y, leaves, dy.transpose(1, 2))
    for a, b in zip(out["cuda"], out["reference"]):
        tol = 1e-4 if a.dtype == torch.float32 else 1e-2
        assert float((a.float() - b.float()).abs().max()) <= tol * max(
            1.0, float(b.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_bit_exact_vs_plain_version_on_the_card(cuda_device,
                                                             dtype):
    g = torch.Generator().manual_seed(3)
    for B, T, C in [(1, 1, 2560), (2, 200, 300), (3, 64, 2560)]:
        a = (torch.rand(B, T, C, generator=g) * 0.4 + 0.5).to(cuda_device,
                                                              dtype)
        b = (torch.randn(B, T, C, generator=g) * 0.1).to(cuda_device, dtype)
        before = rglru_scan.launches
        h = rglru_scan(a, b)
        torch.cuda.synchronize()
        assert rglru_scan.launches == before + 1
        assert torch.equal(h, rglru_ref(a, b)), (B, T, C)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_bwd_kernel_bit_exact_vs_plain_version_on_the_card(
        cuda_device, dtype):
    """The RG-LRU backward kernel == its plain loop bit for bit (ragged T
    and C, T at a tile +- 1, a strided g), on the wrapper's path and on the
    direct path forced, one launch a call; under autograd ``rglru`` runs
    both kernels and equals its ``reference`` executor bit for bit."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.rglru.rglru")
    g = torch.Generator().manual_seed(5)
    for B, T, C in [(1, 1, 2560), (2, 200, 300), (3, 64, 2560),
                    (2, 63, 2560), (2, 65, 2560), (1, 700, 2560)]:
        a = (torch.rand(B, T, C, generator=g) * 0.4 + 0.5).to(cuda_device,
                                                              dtype)
        b = (torch.randn(B, T, C, generator=g) * 0.1).to(cuda_device, dtype)
        gr = torch.randn(B, T, 2 * C, generator=g).to(cuda_device,
                                                       dtype)[..., :C]
        h = rglru_scan(a, b)
        rda, rdb = rglru_bwd_ref(a, h, gr)
        # the wrapper's path, then the direct path forced
        for plan in (None, lambda orig, *x: (orig(*x)[0], False)):
            before = rglru_scan_bwd.launches
            with _forced(mod, "bwd_plan", plan):
                da, db = rglru_scan_bwd(a, h, gr)
            torch.cuda.synchronize()
            assert rglru_scan_bwd.launches == before + 1
            assert da.dtype == db.dtype == torch.float32
            assert torch.equal(da, rda) and torch.equal(db, rdb), \
                (B, T, C, plan is None)
    x = [t.detach().requires_grad_() for t in (a, b)]
    out = {}
    for ex in ("cuda", "reference"):
        h = rglru(*x, executor=ex)
        out[ex] = (h, torch.autograd.grad(h, x, gr.contiguous()))
    assert torch.equal(out["cuda"][0], out["reference"][0])
    for p, q in zip(out["cuda"][1], out["reference"][1]):
        assert p.dtype == dtype and torch.equal(p, q)
