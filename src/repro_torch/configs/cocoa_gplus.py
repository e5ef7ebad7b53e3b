"""CoCoA+ run settings for the §4 G+ logreg experiment (Fig. 2's CoCoA+ curve).

Ma et al. (arXiv:1502.03508) parameterize CoCoA+ by the aggregation γ and
the subproblem parameter σ'; the safe choice for γ=1 (adding) is σ' = γK,
which is what makes the method slow on this problem — the paper's point is
exactly that σ' must scale with K=10,000 while the local SDCA pass only
sees ~216 examples.  ``sigma=None`` selects the safe γK at problem-build
time; the local solver is one SDCA permutation pass per round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CoCoARunConfig:
    name: str = "cocoa-gplus"
    citation: str = "arXiv:1502.03508"
    sigma: Optional[float] = None   # σ': None -> safe γK
    gamma: float = 1.0              # fixed at 1 ("adding") in this repro

CONFIG = CoCoARunConfig()
