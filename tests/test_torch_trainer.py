"""The port's trainer and checkpoints, on the CPU at smoke widths: the ports
of tests/test_infra.py's checkpoint and restart tests, checkpoints crossing
between the packages (the same on-disk layout; recurrentgemma's list of
layers as ``.params/layers/<i>/...``), and the training launcher (its CLI,
and ``main`` in process for qwen2-0.5b and olmo-1b).

A float32 smoke model makes the two packages' losses comparable: held to
rtol 2e-6, as in tests/test_torch_train.py.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import restore_latest as j_restore_latest
from repro.configs import get_smoke_config
from repro.data import SyntheticSource as JSyntheticSource
from repro.data import batches as j_batches
from repro.models import build as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.train import init_train_state as j_init
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import train as j_train
from repro_torch.ckpt import (AsyncCheckpointer, available_steps,
                              restore_latest, save)
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import SyntheticSource, batches
from repro_torch.models import build as tbuild
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state
from repro_torch.train.trainer import TrainerConfig, train

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OPT = dict(lr=1e-3, total_steps=12)


def _leaves(state):
    from repro_torch.tree import leaves
    return leaves(state)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_init_train_state_draws_on_its_device_from_the_seed(arch):
    """The weights come from a generator on the state's device seeded with
    the int (on the CPU: a CPU generator's stream), with zero moments."""
    bundle = tbuild(t_get_smoke_config(arch))
    state = init_train_state(bundle, 3, device="cpu")
    want = bundle.init_params(torch.Generator(device="cpu").manual_seed(3),
                              device="cpu")
    other = init_train_state(bundle, 4, device="cpu")
    for a, b in zip(_leaves(state.params), _leaves(want)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert not torch.equal(state.params["embed"], other.params["embed"])
    assert all(not x.any() for x in _leaves(state.opt.mu))
    assert int(state.step) == 0


def test_checkpoint_roundtrip_bf16():
    cfg = t_get_smoke_config("qwen2-0.5b")
    state = init_train_state(tbuild(cfg), 0, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        save(d, 7, state)
        restored, step = restore_latest(d, state)
        assert step == 7
        for a, b in zip(_leaves(restored), _leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert state.params["embed"].dtype == torch.bfloat16


def test_checkpoint_damaged_falls_back():
    cfg = t_get_smoke_config("qwen2-0.5b")
    state = init_train_state(tbuild(cfg), 0, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, state)
        save(d, 2, state)
        os.truncate(os.path.join(d, "step_2", "arrays.npz"), 16)
        restored, step = restore_latest(d, state)
        assert step == 1 and restored is not None
    with tempfile.TemporaryDirectory() as d:
        assert restore_latest(d, state) == (None, -1)


def test_async_checkpointer_keeps_the_newest():
    cfg = t_get_smoke_config("qwen2-0.5b")
    state = init_train_state(tbuild(cfg), 0, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, keep=2)
        for s in (1, 2, 3):
            ck.maybe_save(s, state)
            ck.wait()
        ck.final_save(4, state)
        assert available_steps(d) == [3, 4] and ck.last_saved == 4
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read() == "4"


def test_train_restart_resumes_exactly():
    cfg = t_get_smoke_config("olmo-1b")
    bundle = tbuild(cfg)
    it = batches(SyntheticSource(cfg.vocab_size, 4096), batch=2, seq=16,
                 tuned=False)
    with tempfile.TemporaryDirectory() as d:
        _, rep1 = train(bundle, AdamWConfig(**OPT), it,
                        TrainerConfig(total_steps=8, ckpt_dir=d,
                                      ckpt_every=4, log_every=0),
                        device="cpu")
        assert rep1.restored_from == -1 and rep1.steps_run == 8
        _, rep2 = train(bundle, AdamWConfig(**OPT), it,
                        TrainerConfig(total_steps=12, ckpt_dir=d,
                                      ckpt_every=4, log_every=0),
                        device="cpu")
        assert rep2.restored_from == 8
        assert rep2.steps_run == 4
        assert all(np.isfinite(rep1.losses + rep2.losses))


def _f32(arch):
    return (dataclasses.replace(get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(t_get_smoke_config(arch), dtype="float32"))


def _keep_only(d, step):
    for s in available_steps(d):
        if s != step:
            shutil.rmtree(os.path.join(d, f"step_{s}"))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write(str(step))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-0.5b",
                                  "recurrentgemma-2b", "rwkv6-7b"])
def test_port_resumes_a_jax_checkpoint(arch):
    """The JAX trainer runs 8 steps, checkpointing at 4; the port restores
    step 4 from JAX's files, runs steps 5-8 on the same batches, and gives
    JAX's losses."""
    cfg, tcfg = _f32(arch)
    jit = j_batches(JSyntheticSource(cfg.vocab_size, 4096), batch=2, seq=24,
                    tuned=False)
    tit = batches(SyntheticSource(cfg.vocab_size, 4096), batch=2, seq=24,
                  tuned=False)
    for _ in range(4):
        next(tit)                      # the port starts at batch 5
    with tempfile.TemporaryDirectory() as d:
        _, jrep = j_train(jbuild(cfg), JAdamW(**OPT), jit,
                          JTrainerConfig(total_steps=8, ckpt_dir=d,
                                         ckpt_every=4, log_every=0))
        _keep_only(d, 4)
        state, trep = train(tbuild(tcfg), AdamWConfig(**OPT), tit,
                            TrainerConfig(total_steps=8, ckpt_dir=d,
                                          ckpt_every=4, log_every=0),
                            device="cpu")
        assert trep.restored_from == 4 and trep.steps_run == 4
        np.testing.assert_allclose(trep.losses, jrep.losses[4:], rtol=2e-6)
        assert int(state.step) == 8
        assert available_steps(d) == [4, 8]


def test_jax_resumes_a_port_checkpoint():
    """The other way: the port checkpoints a converted JAX state at step 0
    after two of its own steps; JAX's restore reads it by leaf order and
    continues with the port's losses."""
    cfg, tcfg = _f32("qwen3-0.6b")
    from repro_torch import convert
    js0 = j_init(jbuild(cfg), jax.random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as d:
        tit = batches(SyntheticSource(cfg.vocab_size, 4096), batch=2, seq=24,
                      tuned=False)
        ts = convert.train_state_from_jax(jax.device_get(js0), tcfg, "cpu")
        save(d, 0, ts)                 # the JAX init, in the port's files
        _, trep = train(tbuild(tcfg), AdamWConfig(**OPT), tit,
                        TrainerConfig(total_steps=4, ckpt_dir=d,
                                      ckpt_every=2, log_every=0),
                        device="cpu")
        assert trep.restored_from == 0
        _keep_only(d, 2)
        restored, step = j_restore_latest(d, js0)
        assert step == 2 and int(restored.step) == 2
        jit = j_batches(JSyntheticSource(cfg.vocab_size, 4096), batch=2,
                        seq=24, tuned=False)
        for _ in range(2):
            next(jit)
        _, jrep = j_train(jbuild(cfg), JAdamW(**OPT), jit,
                          JTrainerConfig(total_steps=4, ckpt_dir=d,
                                         ckpt_every=2, log_every=0))
        assert jrep.restored_from == 2
        np.testing.assert_allclose(jrep.losses, trep.losses[2:], rtol=2e-6)


def test_checkpoint_files_name_jax_paths():
    """meta.json lists JAX's paths, in JAX's flatten order, with JAX's
    dtype names; bf16 leaves are stored as uint16."""
    _check_jax_paths("qwen3-0.6b")


def test_hybrid_checkpoint_files_name_jax_paths():
    """recurrentgemma's list of layers: list items by index, in JAX's
    order, and a bf16 state round-trips through the port's restore."""
    tstate = _check_jax_paths("recurrentgemma-2b",
                              (".params/layers/2/attn/wq",
                               ".opt/.mu/layers/0/rec/lam"))
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, tstate)
        restored, step = restore_latest(d, tstate)
        assert step == 3
        for a, b in zip(_leaves(restored), _leaves(tstate)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _check_jax_paths(arch, must_have=()):
    """Both packages save a fresh state of ``arch``; their meta.json files
    agree.  Returns the port's state."""
    cfg = get_smoke_config(arch)
    js = j_init(jbuild(cfg), jax.random.PRNGKey(0))
    tstate = init_train_state(tbuild(t_get_smoke_config(arch)), 0,
                              device="cpu")
    from repro.ckpt import save as j_save
    import json
    with tempfile.TemporaryDirectory() as d:
        j_save(d, 1, js)
        save(os.path.join(d, "port"), 1, tstate)
        metas = [json.load(open(os.path.join(p, "step_1", "meta.json")))
                 for p in (d, os.path.join(d, "port"))]
        for k in ("paths", "dtypes", "shapes"):
            assert metas[0][k] == metas[1][k], k
        arrs = np.load(os.path.join(d, "port", "step_1", "arrays.npz"))
        i = metas[1]["paths"].index(".params/embed")
        assert arrs[f"a{i}"].dtype == np.uint16
        assert all(p in metas[1]["paths"] for p in must_have)
    return tstate


def test_trainer_checks_its_device():
    cfg = t_get_smoke_config("qwen3-0.6b")
    it = batches(SyntheticSource(cfg.vocab_size, 4096), batch=2, seq=16,
                 tuned=False)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(tbuild(cfg), AdamWConfig(), it, TrainerConfig(total_steps=1))


def test_launch_train_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "qwen3-0.6b-smoke" in out.stdout
    assert "final loss" in out.stdout and "over 3 steps" in out.stdout


def test_launch_train_cli_saves_and_resumes_hybrid_on_cpu():
    """recurrentgemma through the launcher: 3 steps with a checkpoint, then
    a run to 5 steps resumes from it and runs 2."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        outs = []
        for steps in (3, 5):
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 "recurrentgemma-2b", "--smoke", "--device", "cpu",
                 "--steps", str(steps), "--batch", "2", "--seq", "32",
                 "--ckpt-dir", d],
                capture_output=True, text=True, env=env, timeout=300,
                cwd=ROOT)
            assert out.returncode == 0, out.stderr
            outs.append(out.stdout)
        assert "recurrentgemma-smoke" in outs[0]
        assert "over 3 steps" in outs[0] and "over 2 steps" in outs[1]
        assert available_steps(d) == [3, 5]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmo-1b"])
def test_launch_train_main_trains_dense_archs_on_cpu(arch, capsys):
    """The launcher called in process, as the card's phase 26c calls it
    (here with ``--smoke --device cpu``): qwen2-0.5b (JAX's launcher
    example) and olmo-1b take three steps, every loss finite."""
    from repro_torch.launch.train import main

    rep = main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--seq", "32"])
    assert rep.steps_run == 3 and len(rep.losses) == 3
    assert np.isfinite(rep.losses).all()
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out and "over 3 steps" in out


def test_launch_train_refuses_multi_card_options():
    """--tp 2 and the production meshes need worlds of 2 and 256 / 512
    ranks (tests/test_torch_mesh.py): in one process they raise as JAX's
    mesh does without the devices."""
    from repro_torch.launch.train import main
    for extra in (["--tp", "2"], ["--production-mesh"],
                  ["--production-mesh", "--multi-pod"]):
        with pytest.raises(ValueError, match="Number of ranks 1"):
            main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                  *extra])
