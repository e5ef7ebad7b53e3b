"""DANE run settings for the §4 G+ logreg experiment (Fig. 2's DANE curve).

Shamir et al. (arXiv:1312.7853) analyze DANE for quadratics; on the sparse
non-IID logistic problem the paper reports it converging poorly — which the
reproduction shows too.  The logistic subproblem has no closed form, so the
local solver is ``local_steps`` GD iterations; µ > 0 is required for
stability here (µ = 0, the quadratic-case default, diverges on this data),
and the local stepsize is swept retrospectively like every other curve in
``benchmarks/fig2_convergence.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DANERunConfig:
    name: str = "dane-gplus"
    citation: str = "arXiv:1312.7853"
    eta: float = 1.0                                    # η (eq. 10)
    mu: float = 3.0                                     # µ (eq. 10)
    local_steps: int = 25                               # GD solver iterations
    local_lr: float = 0.3                               # default outside sweeps
    local_lr_sweep: Tuple[float, ...] = (0.1, 0.3, 1.0)  # retrospective best

CONFIG = DANERunConfig()
