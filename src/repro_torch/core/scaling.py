"""Sparsity-pattern statistics behind FSVRG's S_k and A matrices (§3.6.1) —
the port of the reference's ``core/scaling.py``:

  n^j   — #examples with nonzero coordinate j
  n_k^j — #examples on client k with nonzero coordinate j
  φ^j   = n^j / n,   φ_k^j = n_k^j / n_k
  s_k^j = φ^j / φ_k^j           (stochastic-gradient scaling, S_k = Diag)
  ω^j   — #clients containing coordinate j
  a^j   = K / ω^j               (aggregation scaling, A = Diag)

Counts are integer sums in float32, so they match the reference exactly.
:func:`client_feature_counts` and :func:`s_k_diag` take one client's
(m, nnz) rows or a whole bucket's (Kb, m, nnz) rows — materialized or
regenerated, so S_k of a chunk of virtual clients is formed the same way.
On a virtual problem n^j and ω^j stream over regenerated client chunks
(:class:`~repro_torch.core.problem.VirtualFlat`), the same integer sums.
:func:`expert_occupancy` is the MoE router's counterpart of n_k^j.
"""
from __future__ import annotations

import torch

#: clients a block when ω counts a materialized bucket
_OMEGA_CHUNK = 1024


def global_feature_counts(flat) -> torch.Tensor:
    """n^j for a LogRegProblem, or streamed by a VirtualFlat."""
    if hasattr(flat, "feature_counts"):
        return flat.feature_counts()
    present = (flat.val != 0).to(torch.float32)
    return torch.zeros((flat.num_features,), dtype=torch.float32,
                       device=flat.device).index_add_(
        0, flat.idx.reshape(-1), present.reshape(-1))


def client_feature_counts(idx: torch.Tensor, val: torch.Tensor,
                          num_features: int) -> torch.Tensor:
    """n_k^j for one client's (m, nnz) rows -> (d,), or for a bucket's
    (Kb, m, nnz) rows -> (Kb, d).  Padded rows have val == 0."""
    if idx.dim() == 2:
        return client_feature_counts(idx[None], val[None], num_features)[0]
    Kb = idx.shape[0]
    present = (val != 0).to(torch.float32).reshape(Kb, -1)
    return torch.zeros((Kb, num_features), dtype=torch.float32,
                       device=idx.device).scatter_add_(
        1, idx.reshape(Kb, -1), present)


def omega(problem) -> torch.Tensor:
    """ω^j — #clients whose data touches coordinate j."""
    if getattr(problem, "virtual", None) is not None:
        return problem.flat.omega()
    d = problem.d
    om = torch.zeros((d,), dtype=torch.float32, device=problem.device)
    for b in problem.buckets:
        # _OMEGA_CHUNK clients at a time: a (chunk, d) block of counts, not
        # the bucket's (Kb, d); integer sums, so the result is the same
        for c0 in range(0, b.num_clients, _OMEGA_CHUNK):
            cc = client_feature_counts(b.idx[c0:c0 + _OMEGA_CHUNK],
                                       b.val[c0:c0 + _OMEGA_CHUNK], d)
            om = om + (cc > 0).sum(dim=0).to(torch.float32)
    return om


def aggregation_diag(problem) -> torch.Tensor:
    """A = Diag(K / ω^j); coordinates on no client get a^j = 1."""
    om = omega(problem)
    # a tensor numerator: torch computes `scalar / tensor` as
    # reciprocal(tensor) · scalar, which rounds differently from K / ω
    K = torch.full_like(om, float(problem.num_clients))
    return torch.where(om > 0, K / om.clamp(min=1.0), 1.0)


def s_k_diag(phi_global: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             n_k: torch.Tensor) -> torch.Tensor:
    """s_k^j = φ^j / φ_k^j; 1 where the client lacks j.  One client's rows
    and scalar n_k give (d,); a bucket's rows and (Kb,) n_k give (Kb, d)."""
    nkj = client_feature_counts(idx, val, phi_global.shape[0])
    nkf = n_k.to(torch.float32).clamp(min=1.0)
    phi_k = nkj / (nkf[:, None] if nkj.dim() == 2 else nkf)
    return torch.where(nkj > 0, phi_global / phi_k.clamp(min=1e-12), 1.0)


def expert_occupancy(router_probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """MoE analogue of n_k^j: which experts this client's tokens route to.

    router_probs: (tokens, E) softmax router outputs for one client's batch.
    Returns (E,) f32 counts of the tokens whose top-k includes each expert;
    equal probabilities keep the lower expert first (``jax.lax.top_k``'s
    rule, a stable descending sort here)."""
    topi = torch.sort(router_probs, dim=-1, descending=True,
                      stable=True).indices[:, :top_k]
    onehot = torch.zeros(router_probs.shape, dtype=torch.float32,
                         device=router_probs.device).scatter_(1, topi, 1.0)
    return onehot.sum(0)
