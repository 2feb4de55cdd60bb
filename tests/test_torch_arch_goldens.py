"""The float32 goldens of the archs that ``chip_smoke.py`` phase 26 holds
the card to (``tests/torch_goldens/make_lm_golden.py`` and
``make_train_golden.py``, JAX on the CPU): each file's header names its
arch, its depth cut and its seeds, and the port builds that arch at that
cut with the golden's parameter count (on ``meta``: nothing is drawn).
"""
import dataclasses
import json
import os

import pytest

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.tree import leaves

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_goldens")

#: Serving goldens: (arch, file, layers kept; None: full depth).
LM = (("qwen2-0.5b", "lm_qwen2_0_5b.json", None),
      ("olmo-1b", "lm_olmo_1b.json", None),
      ("yi-9b", "lm_yi_9b.json", 4),
      ("moonshot-v1-16b-a3b", "lm_moonshot_v1_16b_a3b.json", 2))
#: Training goldens: (arch, file, the family's extra input seed).
TRAIN = (("qwen2-0.5b", "train_qwen2_0_5b.json", None),
         ("whisper-small", "train_whisper_small.json", 2),
         ("qwen2-vl-2b", "train_qwen2_vl_2b.json", 2))


def _load(file):
    with open(os.path.join(GOLDENS, file)) as f:
        return json.load(f)


def _parameters(arch, num_layers):
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=num_layers)
    params = build(cfg).init_params(0, device="meta")
    return cfg, sum(x.numel() for x in leaves(params))


def _names_its_cut(gold, arch, kept):
    full = get_config(arch).num_layers
    if kept is None:
        assert gold["depth_cut"] is None
    else:
        assert gold["depth_cut"].startswith(f"{kept} of {full} layers")
    assert gold["peak_host_gb"] > 0 and gold["seconds"] > 0


@pytest.mark.parametrize("arch,file,kept", LM, ids=[a for a, _, _ in LM])
def test_serving_golden_names_arch_cut_and_seeds(arch, file, kept):
    gold = _load(file)
    assert gold["arch"] == arch and gold["dtype"] == "float32"
    _names_its_cut(gold, arch, kept)
    assert (gold["seed"], gold["prompt_seed"], gold["extra_seed"]) == (0, 1,
                                                                       2)
    assert gold["config"]["num_layers"] == (kept or
                                            get_config(arch).num_layers)
    cfg, n = _parameters(arch, gold["config"]["num_layers"])
    assert dataclasses.asdict(cfg) == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in gold["config"].items()}
    assert n == gold["parameters"]
    B, N = gold["batch"], gold["new_tokens"]
    assert len(gold["steps"]) == N and len(gold["tokens"]) == B
    if cfg.moe is not None:
        # every token's expert set and router margin, layer by layer
        L = cfg.num_layers
        for i, s in enumerate(gold["steps"]):
            assert len(s["experts"]) == len(s["router_margins"]) == L
            rows = B * (gold["prompt_len"] if i == 0 else 1)
            assert all(len(e) == rows and len(e[0]) == cfg.moe.top_k
                       for e in s["experts"])


@pytest.mark.parametrize("arch,file,extra_seed", TRAIN,
                         ids=[a for a, _, _ in TRAIN])
def test_train_golden_names_arch_cut_and_seeds(arch, file, extra_seed):
    gold = _load(file)
    assert gold["arch"] == arch and gold["dtype"] == "float32"
    _names_its_cut(gold, arch, None)
    assert (gold["seed"], gold["token_seed"]) == (0, 3)
    assert gold.get("extra_seed") == extra_seed
    if get_config(arch).family == "vlm":
        assert gold["image_grid"] ** 2 < gold["seq"]
    assert len(gold["steps"]) == 2
    _, n = _parameters(arch, gold["num_layers"])
    assert n == gold["parameters"]
    # the serving golden of the arch, where there is one, was drawn from
    # the same seed at the same depth: phase 26d trains on its weights
    lm = {a: f for a, f, _ in LM}.get(arch) or {
        "whisper-small": "lm_whisper_small.json",
        "qwen2-vl-2b": "lm_qwen2_vl_2b.json"}[arch]
    serving = _load(lm)
    assert (serving["seed"], serving["config"]["num_layers"]) == (
        gold["seed"], gold["num_layers"])
