"""The paper's own experiment (§4): sparse L2-regularized logistic regression
over public Google+ posts, K=10,000 authors-as-clients.

A copy of the reference package's ``configs/gplus_logreg.py`` (its CONFIG
and ``scaled``; the paper-K and virtual-K configs come with the streamed and
virtual round paths).

The original data cannot be released (footnote 8 of the paper); we generate a
synthetic dataset matching the published statistics:
  n = 2,166,693 examples (scaled by ``scale``), d = 20,002 features
  (bag-of-words 20k + bias + unknown-word), n_k in [75, 9000] (power law),
  per-client feature clustering (non-IID), chronological 75/25 split.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    name: str = "gplus-logreg"
    citation: str = "arXiv:1610.02527 §4"
    num_clients: int = 10_000
    num_features: int = 20_002
    num_examples: int = 2_166_693
    min_client_examples: int = 75
    max_client_examples: int = 9_000
    l2_reg: str = "1/n"            # lambda = 1/n, the paper's choice
    nnz_per_example: int = 60      # bag-of-words sparsity
    scale: float = 1.0             # <1 shrinks n/K proportionally for CI runs

    def scaled(self, scale: float) -> "LogRegConfig":
        K = max(8, int(self.num_clients * scale))
        f = min(1.0, scale * 10)
        n_min = max(2, int(self.min_client_examples * f))
        n_max = max(8, int(self.max_client_examples * f))
        n = max(64, int(self.num_examples * scale))
        # keep the shrunk config *feasible* for the power-law size draw
        # (K·n_min <= n <= ~0.8·K·n_max): an infeasible total saturates
        # every client at n_max and destroys the "unbalanced" property
        n = max(K * n_min, min(n, (8 * K * n_max) // 10))
        return dataclasses.replace(
            self,
            scale=scale,
            num_clients=K,
            num_examples=n,
            num_features=max(32, int(self.num_features * f)),
            min_client_examples=n_min,
            max_client_examples=n_max,
        )


CONFIG = LogRegConfig()
