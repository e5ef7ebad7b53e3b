"""FedAvg run settings for the §4 G+ logreg experiment.

McMahan et al. (arXiv:1602.05629) parameterize FedAvg by the client fraction
C, local epochs E, and local batch size B; this repro runs B=∞ (one
sequential permutation pass per epoch) so the knobs are E
(``local_epochs``), C (``participation``), and the local stepsize h, swept
retrospectively like every other curve in ``benchmarks/fig2_convergence.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FedAvgRunConfig:
    name: str = "fedavg-gplus"
    citation: str = "arXiv:1602.05629"
    stepsize: float = 0.1                               # h (default outside sweeps)
    stepsize_sweep: Tuple[float, ...] = (0.1, 0.5, 2.0)  # retrospective best-h
    local_epochs: int = 2                               # E
    participation: float = 1.0                          # C


CONFIG = FedAvgRunConfig()
