"""Finite-state machine shared by the three tuning algorithms (paper Fig. 1).

States:
    SLOW_START -> INCREASE <-> WARNING -> RECOVERY -> INCREASE

Feedback is a tri-valued signal computed by each tuner from its own metric
(energy for ME, throughput for EEMT/EETT):

    POSITIVE  — metric improved beyond the β band
    NEUTRAL   — within the (−α, +β) band
    NEGATIVE  — degraded beyond the α band
"""
from __future__ import annotations

import torch

SLOW_START = 0
INCREASE = 1
WARNING = 2
RECOVERY = 3

POSITIVE = 1
NEUTRAL = 0
NEGATIVE = -1


def _tri(pos, neg):
    return torch.where(pos, POSITIVE,
                       torch.where(neg, NEGATIVE, NEUTRAL)).to(torch.int32)


def feedback_from_ratio(value, reference, alpha, beta):
    """Tri-valued feedback for a *higher-is-better* metric (throughput)."""
    return _tri(value > (1.0 + beta) * reference,
                value < (1.0 - alpha) * reference)


def feedback_from_cost(value, reference, alpha, beta):
    """Tri-valued feedback for a *lower-is-better* metric (energy)."""
    return _tri(value < (1.0 - alpha) * reference,
                value > (1.0 + beta) * reference)
