"""`Trainer` — the round-loop driver every solver shares, ported from the
reference's ``core/trainer.py`` (its eager loop):

  * **Random streams** — round r draws from ``utils.device.generator(seed,
    r)``, a ``torch.Generator`` on the solver's device, r the
    absolute round from ``state.round`` (the counterpart of
    ``fold_in(PRNGKey(seed), r)``).
  * **Eval / history** — ``eval_fn(w) -> dict`` of scalars, recorded as
    Python floats every ``eval_every`` rounds and always after the last;
    ``callback(state, r)`` for side effects.
  * **fail_fast** — :class:`NonFiniteIterateError` the round the iterate
    stops being finite.

Not ported yet: checkpoints, the ``lax.scan`` fast path and ``sweep``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.utils.device import generator

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
    """Final state + per-round eval history."""

    state: SolverState
    history: List[Dict[str, float]]

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
        for r in range(int(state.round), self.rounds):
            gen = generator(self.seed, r, self.solver.device)
            state = self.solver.round(state, gen)
            self._check_finite(state, r)
            if self.eval_fn is not None and self._is_eval_round(r):
                history.append({k: float(v)
                                for k, v in self.eval_fn(state.w).items()})
            if self.callback is not None:
                self.callback(state, r)
        return FitResult(state=state, history=history)
