"""`Trainer` — the round-loop driver every solver shares, ported from the
reference's ``core/trainer.py`` (its eager loop), and :func:`sweep`:

  * **Random streams** — round r runs on the reference's key
    ``fold_in(PRNGKey(seed), r)`` (:mod:`repro_torch.utils.threefry`, its
    words on the solver's device), r the absolute round from
    ``state.round``: the same seed gives the reference's masks,
    permutations and samples, and a restored state resumes them.
  * **Eval / history** — ``eval_fn(w) -> dict`` of scalars, recorded as
    Python floats every ``eval_every`` rounds and always after the last;
    ``callback(state, r)`` for side effects.
  * **fail_fast** — :class:`NonFiniteIterateError` the round the iterate
    stops being finite.

Not ported yet: checkpoints and the ``lax.scan`` fast path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.utils import threefry

EvalFn = Callable[[torch.Tensor], Dict[str, Any]]


class NonFiniteIterateError(RuntimeError):
    """The iterate went NaN/Inf mid-run; carries the solver and round."""

    def __init__(self, solver_name: str, round_index: int):
        super().__init__(
            f"non-finite iterate after round {round_index} of solver "
            f"'{solver_name}' — a diverging stepsize?")
        self.solver_name = solver_name
        self.round_index = int(round_index)


@dataclasses.dataclass
class FitResult:
    """Final state + per-round eval history (plus the solver that produced
    it, for its hyperparams)."""

    state: SolverState
    history: List[Dict[str, float]]
    solver: Optional[FederatedSolver] = None

    @property
    def w(self) -> torch.Tensor:
        return self.state.w


class Trainer:
    """Drives ``solver.round`` for a fixed number of rounds on the solver's
    device."""

    def __init__(self, solver: FederatedSolver, *, rounds: int, seed: int = 0,
                 eval_fn: Optional[EvalFn] = None,
                 callback: Optional[Callable[[SolverState, int], None]] = None,
                 eval_every: int = 1, fail_fast: bool = True):
        if int(eval_every) < 1:
            raise ValueError("eval_every must be >= 1")
        self.solver = solver
        self.rounds = int(rounds)
        self.seed = int(seed)
        self.eval_fn = eval_fn
        self.callback = callback
        self.eval_every = int(eval_every)
        self.fail_fast = bool(fail_fast)

    def _check_finite(self, state: SolverState, r: int) -> None:
        if self.fail_fast and not bool(torch.isfinite(state.w).all()):
            raise NonFiniteIterateError(self.solver.name, r)

    def _is_eval_round(self, r: int) -> bool:
        return (r + 1) % self.eval_every == 0 or r == self.rounds - 1

    def fit(self, w0: Optional[torch.Tensor] = None,
            state: Optional[SolverState] = None) -> FitResult:
        """Run rounds ``state.round .. rounds-1`` from ``init(w0)`` or from
        an explicit ``state``."""
        if state is None:
            state = self.solver.init(w0)
        elif w0 is not None:
            raise ValueError("pass w0 or state, not both")
        history: List[Dict[str, float]] = []
        base = threefry.as_key(threefry.PRNGKey(self.seed),
                               self.solver.device)
        for r in range(int(state.round), self.rounds):
            state = self.solver.round(state, threefry.fold_in(base, r))
            self._check_finite(state, r)
            if self.eval_fn is not None and self._is_eval_round(r):
                history.append({k: float(v)
                                for k, v in self.eval_fn(state.w).items()})
            if self.callback is not None:
                self.callback(state, r)
        return FitResult(state=state, history=history, solver=self.solver)


def sweep(build_solver: Callable[[Any], FederatedSolver],
          candidates: Sequence[Any], *, rounds: int, seed: int = 0,
          eval_fn: EvalFn, objective: str = "f",
          **trainer_kw) -> Tuple[Optional[FitResult], Optional[Any]]:
    """Retrospective hyperparameter sweep (the paper's protocol), as the
    reference's ``sweep``: runs ``build_solver(v)`` for the full round
    budget for every candidate ``v`` and keeps the run whose final
    ``history[-1][objective]`` is lowest; non-finite runs are discarded.
    ``fail_fast`` is off unless the caller sets it: a divergent candidate
    just loses the sweep.  Returns ``(best_result, best_value)``, or
    ``(None, None)`` if every run diverged."""
    best_res, best_v, best_f = None, None, math.inf
    trainer_kw.setdefault("fail_fast", False)
    for v in candidates:
        res = Trainer(build_solver(v), rounds=rounds, seed=seed,
                      eval_fn=eval_fn, **trainer_kw).fit()
        if not res.history:        # degenerate budget (rounds <= start)
            continue
        f = res.history[-1][objective]
        if math.isfinite(f) and f < best_f:
            best_res, best_v, best_f = res, v, f
    return best_res, best_v
