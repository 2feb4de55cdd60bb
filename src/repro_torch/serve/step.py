"""Serving: prefill + single-token decode steps (the port of
``repro/serve/step.py``) for every family ``models.build`` serves: the
dense LM's KV caches, rwkv6's recurrent states and recurrentgemma's mix of
ring caches and recurrent states, through the bundle's ``state_kwarg``."""
from __future__ import annotations

import numpy as np
import torch

from ..api.scenario import resolve_device
from ..kernels.flash_attention.ops import check_executor
from ..models import ModelBundle


def make_decode_step(bundle: ModelBundle, *, executor: str = "auto"):
    """decode_step(params, state, tokens [B,1], positions [B,1])
    -> (next greedy tokens [B,1] int32, logits [B,1,V], new_state)."""
    check_executor(executor)

    def decode_step(params, state, tokens, positions):
        kw = {bundle.state_kwarg: state}
        logits, new_state, _ = bundle.forward(
            params, tokens, positions=positions, executor=executor, **kw)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, new_state

    return decode_step


def make_prefill(bundle: ModelBundle, *, executor: str = "auto"):
    """prefill(params, state, tokens [B,T]) -> (last_logits [B,1,V],
    new_state).  Only the last position's logits are computed
    (``logits_slice=1``): the same values as JAX's ``logits[:, -1:]``
    without the [B, T, V] tensor (5 GB in bf16 at 8 x 2,048 tokens of a
    151,936-token vocabulary)."""
    check_executor(executor)

    def prefill(params, state, tokens):
        kw = {bundle.state_kwarg: state}
        logits, new_state, _ = bundle.forward(
            params, tokens, logits_slice=1, executor=executor, **kw)
        return logits, new_state

    return prefill


@torch.no_grad()
def generate(bundle: ModelBundle, params, prompt, max_new: int,
             max_len: int, *, device=None, executor: str = "auto"):
    """Greedy autoregressive generation (reference host loop).  ``prompt``
    [B, T] (numpy or tensor) is moved to ``device`` (default: the CUDA card;
    raises without one), where ``params`` must live.  Returns [B, max_new]
    int32 tokens."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, torch.Tensor) else prompt, device=dev).long()
    B, T = prompt.shape
    state = bundle.init_decode_state(B, max_len, device=dev)
    prefill = make_prefill(bundle, executor=executor)
    step = make_decode_step(bundle, executor=executor)

    logits, state = prefill(params, state, prompt)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
        tok, _, state = step(params, state, tok, pos)
        out.append(tok)
    return torch.cat(out, dim=1)
