"""The paper's own experiment (§4): sparse L2-regularized logistic regression
over public Google+ posts, K=10,000 authors-as-clients.

A copy of the reference package's ``configs/gplus_logreg.py``: CONFIG and
``scaled``, and the scale paths' PAPER_K_CONFIG, VIRTUAL_K_CONFIG and
``get_virtual_k_config``.

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

#: The paper-scale *client axis* on a CI box: the §4 experiment's K = 10,000
#: clients kept exact, with d and the per-client example counts shrunk so a
#: full federated round fits CPU CI.  The point of this config is the K —
#: the streamed (client_chunk) round path must handle the paper's "massively
#: distributed" regime, where materializing the (K, d) delta stack is what
#: breaks first, not the FLOPs.
PAPER_K_CONFIG = LogRegConfig(
    name="gplus-logreg-paper-k",
    num_clients=10_000,
    num_features=2_002,
    num_examples=60_000,
    min_client_examples=3,
    max_client_examples=24,
    nnz_per_example=12,
)

#: The thesis-scale client axis: "as many nodes as there are users of the
#: service" (§1.2).  d and n_k are kept small enough that a *virtual* round
#: (rows regenerated on demand inside the scan — EngineConfig.virtual_data)
#: is CPU-feasible at K up to 10⁶, while materializing the same dataset
#: at K=10⁶ would be ~4·10⁶ examples of (nnz+2)-wide rows — the regime the
#: virtual layout exists for.  Use :func:`get_virtual_k_config` to pick K.
VIRTUAL_K_CONFIG = LogRegConfig(
    name="gplus-logreg-virtual-k",
    num_clients=100_000,
    num_features=202,
    num_examples=400_000,
    min_client_examples=2,
    max_client_examples=8,
    nnz_per_example=6,
)


def get_virtual_k_config(num_clients: int) -> LogRegConfig:
    """VIRTUAL_K_CONFIG at a chosen K, total examples tracking 4·K so the
    per-client size distribution is K-independent."""
    if num_clients < 8:
        raise ValueError("num_clients must be >= 8")
    return dataclasses.replace(
        VIRTUAL_K_CONFIG,
        name=f"gplus-logreg-virtual-k{num_clients}",
        num_clients=num_clients,
        num_examples=4 * num_clients,
    )
