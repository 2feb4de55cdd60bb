"""Serving for the dense LM (the port of ``repro/serve``): prefill, decode,
greedy generation and the SLA-governed continuous batcher."""
from .step import generate, make_decode_step, make_prefill  # noqa: F401
from .scheduler import ContinuousBatcher, Request  # noqa: F401
