"""The `FederatedSolver` protocol — one front door for every round-based
algorithm, ported from the reference's ``core/solver.py``:

  * ``init(w0) -> SolverState`` — the iterate ``w``, per-client auxiliary
    state ``aux`` (empty for stateless algorithms) and the ``round`` count;
  * ``round(state, key) -> SolverState`` — one round of communication,
    drawing its randomness from the round's key (a
    :mod:`repro_torch.utils.threefry` key, the reference's round key);
    deterministic solvers ignore it;
  * ``name`` / ``hyperparams`` — the registry name and the knobs the
    solver was built with;
  * ``fit(rounds, ...)`` — a wrapper over
    :class:`repro_torch.core.trainer.Trainer`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.problem import FederatedLogReg
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Everything a solver carries between rounds.

    w     : (d,) the server iterate.
    aux   : per-client auxiliary state, one entry per bucket, or ().
    round : the round count; the Trainer runs round r on the key
            ``fold_in(PRNGKey(seed), r)``, so a restored state resumes the
            same draws.
    """

    w: torch.Tensor
    aux: Any = ()
    round: int = 0

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)


class FederatedSolver:
    """Base class of round-based federated algorithms.

    Subclasses set ``name`` and implement :meth:`round`.  Constructors take
    the problem first and a ``device`` (default: the CUDA card), which must
    be the device the problem lives on."""

    name: str = "solver"
    problem: FederatedLogReg
    device: torch.device

    def _bind(self, problem: FederatedLogReg, device: DeviceLike) -> None:
        self.problem = problem
        self.device = resolve_device(device)
        if problem.device.type != self.device.type:
            raise ValueError(f"the problem lives on {problem.device}, the "
                             f"solver was asked for {self.device}")

    def _scratch(self, name: str, rows: int, *,
                 zeros: bool = False) -> torch.Tensor:
        """A (≥ rows, d) scratch of the client passes kept on the solver
        under ``name``, grown when a pass needs more rows (the cohort
        round's overflow fallback); ``zeros`` makes a new one all zeros.
        A solver sizes it once to :meth:`RoundEngine.pass_rows`: the
        largest bucket on the plain round, a chunk or a cohort on the
        scale paths."""
        buf = getattr(self, name, None)
        if buf is None or buf.shape[0] < rows:
            make = torch.zeros if zeros else torch.empty
            buf = make((rows, self.problem.d), device=self.problem.device)
            setattr(self, name, buf)
        return buf

    def init(self, w0: Optional[torch.Tensor] = None) -> SolverState:
        """Fresh solver state at iterate ``w0`` (zeros by default)."""
        if w0 is None:
            w0 = torch.zeros((self.problem.d,), device=self.problem.device)
        return SolverState(w=w0)

    def round(self, state: SolverState,
              key: threefry.Key) -> SolverState:
        raise NotImplementedError

    @property
    def hyperparams(self) -> Dict[str, Any]:
        """The knobs this solver was constructed with: its config's fields,
        where it has one."""
        cfg = getattr(self, "cfg", None)
        if dataclasses.is_dataclass(cfg):
            return dataclasses.asdict(cfg)
        return {}

    def fit(self, rounds: int, *, seed: int = 0, w0=None, state=None,
            eval_fn=None, **trainer_kw):
        """Run ``rounds`` rounds through the shared Trainer driver."""
        from repro_torch.core.trainer import Trainer
        return Trainer(self, rounds=rounds, seed=seed, eval_fn=eval_fn,
                       **trainer_kw).fit(w0=w0, state=state)

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v!r}" for k, v in self.hyperparams.items())
        return f"{type(self).__name__}({self.name}: {hp})"
