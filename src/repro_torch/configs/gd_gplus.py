"""Distributed-GD run settings for the §4 G+ logreg experiment.

The "trivial benchmark" (teal diamonds in Fig. 2): one exact gradient step
per round of communication, stepsize picked retrospectively like every
other curve.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GDRunConfig:
    name: str = "gd-gplus"
    citation: str = "arXiv:1610.02527 §2"
    stepsize: float = 2.0                                          # default outside sweeps
    stepsize_sweep: Tuple[float, ...] = (0.5, 2.0, 8.0, 32.0)      # retrospective best-h


CONFIG = GDRunConfig()
