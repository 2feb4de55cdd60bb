"""Serving (the port of ``repro/serve``): prefill, decode and greedy
generation for the dense, ssm and hybrid families, and the SLA-governed
continuous batcher for the dense family."""
from .step import generate, make_decode_step, make_prefill  # noqa: F401
from .scheduler import ContinuousBatcher, Request  # noqa: F401
