"""Serving: prefill + single-token decode steps (the port of
``repro/serve/step.py``) for every family ``models.build`` serves: the
decoder-only LMs' KV caches (dense, MoE, VLM), whisper's per-layer caches,
rwkv6's recurrent states and recurrentgemma's mix of ring caches and
recurrent states, through the bundle's ``state_kwarg``.

Extra forward inputs go through as keywords: the prefill takes all of
them (``vision_embeds``, ``mrope_pos``, ``enc_out``, ``frame_embeds``);
the decode step takes them too, and whisper's needs ``enc_out`` at every
step.  JAX's ``make_decode_step`` passes none (ROADMAP queue 3), so its
whisper cannot decode through it.  A VLM decode step passes positions
only (plain RoPE at T + i), as JAX's decode does."""
from __future__ import annotations

import numpy as np
import torch

from ..api.scenario import resolve_device
from ..kernels.flash_attention.ops import check_executor
from ..models import ModelBundle


#: The extra inputs a decode step needs again (JAX's prefill-only inputs,
#: ``vision_embeds`` and ``mrope_pos``, are not passed on).
DECODE_KEYS = ("enc_out",)


def make_decode_step(bundle: ModelBundle, *, moe_impl: str = "gmm",
                     executor: str = "auto"):
    """decode_step(params, state, tokens [B,1], positions [B,1], **extra)
    -> (next greedy tokens [B,1] int32, logits [B,1,V], new_state)."""
    check_executor(executor)

    def decode_step(params, state, tokens, positions, **extra):
        kw = {bundle.state_kwarg: state}
        logits, new_state, _ = bundle.forward(
            params, tokens, positions=positions, moe_impl=moe_impl,
            executor=executor, **kw, **extra)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, new_state

    return decode_step


def make_prefill(bundle: ModelBundle, *, moe_impl: str = "gmm",
                 executor: str = "auto"):
    """prefill(params, state, tokens [B,T], **extra) -> (last_logits
    [B,1,V], new_state).  Only the last position's logits are computed
    (``logits_slice=1``): the same values as JAX's ``logits[:, -1:]``
    without the [B, T, V] tensor (5 GB in bf16 at 8 x 2,048 tokens of a
    151,936-token vocabulary)."""
    check_executor(executor)

    def prefill(params, state, tokens, **extra):
        kw = {bundle.state_kwarg: state}
        logits, new_state, _ = bundle.forward(
            params, tokens, logits_slice=1, moe_impl=moe_impl,
            executor=executor, **kw, **extra)
        return logits, new_state

    return prefill


@torch.no_grad()
def generate(bundle: ModelBundle, params, prompt, max_new: int,
             max_len: int, *, moe_impl: str = "gmm", device=None,
             executor: str = "auto", **extra):
    """Greedy autoregressive generation (reference host loop).  ``prompt``
    [B, T] (numpy or tensor) is moved to ``device`` (default: the CUDA card;
    raises without one), where ``params`` and the ``extra`` inputs must
    live.  ``extra`` goes to the prefill, and its :data:`DECODE_KEYS`
    (whisper's ``enc_out``, from ``models.whisper.encode``) to every decode
    step.  Returns [B, max_new] int32 tokens."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, torch.Tensor) else prompt, device=dev).long()
    B, T = prompt.shape
    state = bundle.init_decode_state(B, max_len, device=dev)
    prefill = make_prefill(bundle, moe_impl=moe_impl, executor=executor)
    step = make_decode_step(bundle, moe_impl=moe_impl, executor=executor)
    again = {k: v for k, v in extra.items() if k in DECODE_KEYS}

    logits, state = prefill(params, state, prompt, **extra)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
        tok, _, state = step(params, state, tok, pos, **again)
        out.append(tok)
    return torch.cat(out, dim=1)
