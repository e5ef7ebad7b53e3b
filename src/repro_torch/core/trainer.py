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
  * **Checkpoints** — ``checkpoint_dir`` + ``checkpoint_every`` save the
    state as ``{"w", "aux", "round"}`` through :mod:`repro_torch.checkpoint`
    (the reference's manifest-v3 format, ``round`` a 0-d int32 array, so
    either package's ``Trainer.restore`` reads it); the saved checkpoint
    never lags the returned result.  :meth:`Trainer.restore` rebuilds a
    :class:`~repro_torch.core.solver.SolverState` and ``fit(state=...)``
    resumes from it.

Not ported yet: the ``lax.scan`` fast path (``scan=True``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.utils import threefry
from repro_torch.utils.device import DeviceLike

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


def _tuplify(node):
    """Rebuild the tuples :func:`repro_torch.checkpoint.restore` returns as
    lists."""
    if isinstance(node, (list, tuple)):
        return tuple(_tuplify(x) for x in node)
    if isinstance(node, dict):
        return {k: _tuplify(v) for k, v in node.items()}
    return node


class Trainer:
    """Drives ``solver.round`` for a fixed number of rounds on the solver's
    device."""

    def __init__(self, solver: FederatedSolver, *, rounds: int, seed: int = 0,
                 eval_fn: Optional[EvalFn] = None,
                 callback: Optional[Callable[[SolverState, int], None]] = None,
                 eval_every: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 fail_fast: bool = True):
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every requires a checkpoint_dir")
        if int(eval_every) < 1:
            raise ValueError("eval_every must be >= 1")
        self.solver = solver
        self.rounds = int(rounds)
        self.seed = int(seed)
        self.eval_fn = eval_fn
        self.callback = callback
        self.eval_every = int(eval_every)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.fail_fast = bool(fail_fast)

    def _check_finite(self, state: SolverState, r: int) -> None:
        if self.fail_fast and not bool(torch.isfinite(state.w).all()):
            raise NonFiniteIterateError(self.solver.name, r)

    def _is_eval_round(self, r: int) -> bool:
        return (r + 1) % self.eval_every == 0 or r == self.rounds - 1

    # -- checkpoints ------------------------------------------------------ #

    def save(self, state: SolverState, path: Optional[str] = None) -> None:
        """Save ``state`` under ``path`` (default: ``checkpoint_dir``)."""
        checkpoint.save(path or self.checkpoint_dir,
                        {"w": state.w, "aux": state.aux,
                         "round": np.asarray(int(state.round), np.int32)},
                        step=int(state.round),
                        metadata={"solver": self.solver.name,
                                  "seed": self.seed})

    @staticmethod
    def restore(path: str, device: DeviceLike = None) -> SolverState:
        """The state saved under ``path``, by either package, on ``device``
        (default: the CUDA card)."""
        tree, info = checkpoint.restore(path, device)
        return SolverState(w=tree["w"], aux=_tuplify(tree.get("aux", ())),
                           round=int(tree.get("round", info["step"])))

    # -- the round loop --------------------------------------------------- #

    def fit(self, w0: Optional[torch.Tensor] = None,
            state: Optional[SolverState] = None) -> FitResult:
        """Run rounds ``state.round .. rounds-1`` from ``init(w0)`` or from
        an explicit ``state``."""
        if state is None:
            state = self.solver.init(w0)
        elif w0 is not None:
            raise ValueError("pass w0 or state, not both")
        start = int(state.round)
        if start >= self.rounds:
            # the saved checkpoint never lags the returned result, also for
            # a restored state handed to a fit past its budget
            if self.checkpoint_dir:
                self.save(state)
            return FitResult(state=state, history=[], solver=self.solver)
        history: List[Dict[str, float]] = []
        base = threefry.as_key(threefry.PRNGKey(self.seed),
                               self.solver.device)
        saved_at = -1
        for r in range(start, self.rounds):
            state = self.solver.round(state, threefry.fold_in(base, r))
            self._check_finite(state, r)
            if self.eval_fn is not None and self._is_eval_round(r):
                history.append({k: float(v)
                                for k, v in self.eval_fn(state.w).items()})
            if self.callback is not None:
                self.callback(state, r)
            if (self.checkpoint_every
                    and (r + 1) % self.checkpoint_every == 0):
                self.save(state)
                saved_at = r + 1
        if self.checkpoint_dir and saved_at != self.rounds:
            self.save(state)
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
