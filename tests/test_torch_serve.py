"""``repro_torch.serve`` against ``repro.serve`` on the CPU, float32 smoke
models: greedy ``generate`` and the SLA-governed ``ContinuousBatcher``
(replaying examples/continuous_batching.py: 12 requests, 4 slots) give
JAX's tokens, and the batcher admits the same number of slots at every
step.  Both batchers read the same fake clock (0.1 s a reading), so both
tune at the same steps.  Also: ``launch.serve`` runs on the CPU, and every
serving entry point raises without a card unless the CPU is asked for.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_smoke_config
from repro.core.types import SLA as JSLA
from repro.core.types import SLAPolicy as JPolicy
from repro.models import build as jbuild
from repro.serve import scheduler as jsched
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.types import SLA as TSLA
from repro_torch.core.types import SLAPolicy as TPolicy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.serve import scheduler as tsched


def _bundles(arch, dtype="float32"):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=dtype)
    jb, tb = jbuild(jcfg), tbuild(tcfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jb, tb, jp, tp


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-0.5b"])
def test_generate_gives_jax_tokens(arch):
    jb, tb, jp, tp = _bundles(arch)
    prompt = np.random.default_rng(4).integers(
        0, jb.cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jserve.generate(jb, jp, jnp.asarray(prompt), max_new=12,
                           max_len=40)
    got = tserve.generate(tb, tp, prompt, max_new=12, max_len=40,
                          device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Clock:
    """A monotonic clock that advances 0.1 s at every reading."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 0.1
        return self.t


def _replay(module, batcher_cls, reqs, monkeypatch, **kw):
    monkeypatch.setattr(module, "time", _Clock())
    cb = batcher_cls(**kw)
    for r in reqs:
        cb.submit(r)
    admitted = []
    while cb.queue or any(r is not None for r in cb.active):
        cb.step()
        admitted.append(cb.admitted)
    return admitted


def test_continuous_batcher_replays_the_example(monkeypatch):
    jb, tb, jp, tp = _bundles("qwen2-0.5b")

    def requests(cls):
        rng = np.random.default_rng(0)
        return [cls(i, rng.integers(0, jb.cfg.vocab_size,
                                    int(rng.integers(4, 24)),
                                    dtype=np.int32), max_new=16)
                for i in range(12)]
    jreqs, treqs = requests(jsched.Request), requests(tsched.Request)
    j_adm = _replay(jsched, jsched.ContinuousBatcher, jreqs, monkeypatch,
                    bundle=jb, params=jp, slots=4, max_len=96,
                    sla=JSLA(policy=JPolicy.MAX_THROUGHPUT, max_ch=4,
                             delta_ch=1, timeout_s=0.25))
    t_adm = _replay(tsched, tsched.ContinuousBatcher, treqs, monkeypatch,
                    bundle=tb, params=tp, slots=4, max_len=96,
                    sla=TSLA(policy=TPolicy.MAX_THROUGHPUT, max_ch=4,
                             delta_ch=1, timeout_s=0.25), device="cpu")
    assert all(r.done for r in treqs)
    assert t_adm == j_adm and len(set(t_adm)) > 1   # the tuner did move
    for a, b in zip(treqs, jreqs):
        assert a.out == b.out, a.rid


def test_launch_serve_on_the_cpu():
    toks = tlaunch.main(["--arch", "qwen3-0.6b", "--device", "cpu",
                         "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "4"])
    assert tuple(toks.shape) == (2, 4)
    # --tp 2 needs a world of two ranks (tests/test_torch_mesh.py): in one
    # process it raises as JAX's mesh does without the devices
    with pytest.raises(ValueError, match=r"mesh_shape \(1, 2\)"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--smoke",
                      "--tp", "2"])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_launch_serve_recurrent_on_the_cpu(arch, capsys):
    """The recurrent families through the launcher; on the CPU no kernel
    launches (the plain versions run)."""
    toks = tlaunch.main(["--arch", arch, "--device", "cpu", "--smoke",
                         "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "4"])
    assert tuple(toks.shape) == (2, 4) and toks.dtype == torch.int32
    out = capsys.readouterr().out
    zero = "{'flash_attention': 0, 'wkv': 0, 'rglru': 0}"
    assert f"in the prefill {zero}, in one decode step {zero}" in out


def test_recurrent_entry_points_need_a_card(monkeypatch):
    """As the dense family's: the card unless the CPU is asked for; the
    continuous batcher serves the dense family only, as in JAX."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        tb = tbuild(t_smoke(arch))
        tp = tb.init_params(0, device="cpu")
        for call in (lambda: tb.init_params(0),
                     lambda: tb.init_decode_state(1, 8),
                     lambda: tserve.generate(tb, tp, np.zeros((1, 4),
                                                              np.int32),
                                             max_new=2, max_len=8)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        with pytest.raises(NotImplementedError, match="dense family"):
            tsched.ContinuousBatcher(tb, tp, device="cpu")


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = tbuild(t_smoke("qwen3-0.6b"))
    tp = tb.init_params(0, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    calls = [
        lambda: tb.init_params(0),
        lambda: tb.init_decode_state(1, 8),
        lambda: tserve.generate(tb, tp, prompt, max_new=2, max_len=8),
        lambda: tsched.ContinuousBatcher(tb, tp, slots=2, max_len=8),
        lambda: tlaunch.main(["--arch", "qwen3-0.6b", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="executor='cuda' needs CUDA"):
        tserve.generate(tb, tp, np.zeros((1, 4), np.int32), max_new=2,
                        max_len=8, device="cpu", executor="cuda")
    with pytest.raises(ValueError, match="unknown attention executor"):
        tsched.ContinuousBatcher(tb, tp, device="cpu", executor="blocked")
