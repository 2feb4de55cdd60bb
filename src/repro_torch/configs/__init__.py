"""Architecture registry: the 10 assigned archs + smoke-test reductions (the
port's copy of ``repro/configs``: data only).

Usage:
    from repro_torch.configs import get_config, get_smoke_config, ARCHS
    cfg = get_config("qwen2-0.5b")
"""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen2-0.5b",
    "qwen3-0.6b",
    "olmo-1b",
    "yi-9b",
    "rwkv6-7b",
    "moonshot-v1-16b-a3b",
    "qwen3-moe-30b-a3b",
    "whisper-small",
    "recurrentgemma-2b",
    "qwen2-vl-2b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke_config(name: str):
    return _mod(name).SMOKE


# ------------------------------------------------------------- shapes -----
# Assigned input-shape set (each cell = arch x shape).
SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,    global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,   global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,   global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288,  global_batch=1),
}


def cells(arch: str):
    """Shape cells that apply to this arch (long_500k only if sub-quadratic)."""
    cfg = get_config(arch)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
