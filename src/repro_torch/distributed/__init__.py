"""Partitioning, collectives and expert parallelism over a mesh of ranks
(``sharding``, ``collectives``, ``moe_a2a``), and the lane-batch split of
the engine and the fleets over torch devices (``sharding``)."""
from . import collectives, sharding  # noqa: F401
