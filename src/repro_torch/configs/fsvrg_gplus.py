"""FSVRG run settings for the §4 G+ logreg experiment (Fig. 2's own curve).

Algorithm 4's only free knob is the global stepsize h (the per-client
stepsize is h/n_k, mod. 1); the paper picks it retrospectively, so the
config carries both the default and the sweep grid the benchmark uses.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FSVRGRunConfig:
    name: str = "fsvrg-gplus"
    citation: str = "arXiv:1610.02527 Alg. 4"
    stepsize: float = 1.0                                # h (default outside sweeps)
    stepsize_sweep: Tuple[float, ...] = (0.3, 1.0, 3.0)  # retrospective best-h


CONFIG = FSVRGRunConfig()
