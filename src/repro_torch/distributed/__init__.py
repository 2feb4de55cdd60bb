"""Lane-batch distribution over torch devices (``sharding``).

The JAX package's ``repro.distributed`` also holds the model stack's
parameter partitioning and collectives; those parts are later work of the
port (ROADMAP queue 1, item 9e).
"""
from . import sharding  # noqa: F401
