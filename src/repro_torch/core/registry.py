"""String-keyed solver registry: ``make_solver("fsvrg", problem)`` — the
port of the reference's ``core/registry.py``, with its nine names: the
solvers of Fig. 2 (``fsvrg``, ``svrg_naive``, ``gd``, ``fedavg``,
``dane``, ``cocoa``) and the dense ridge ones (``dane_ridge``, ``primal``,
``dual``).  Defaults come from :mod:`repro_torch.configs`;
``make_solver``'s ``device`` defaults to the CUDA card, as every entry
point's does.

``layout`` records which problem layout a factory expects:

  * ``"sparse"`` — the bucketed sparse logreg problem of
    :func:`repro_torch.core.problem.build_problem` (the paper's §4);
  * ``"dense"``  — a :func:`repro_torch.core.problem.build_dense_problem`
    ridge layout (equal n_k for the Appendix-A methods).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.core.problem import FederatedLogReg
from repro_torch.core.solver import FederatedSolver
from repro_torch.utils.device import DeviceLike

_LAYOUTS = ("sparse", "dense")

#: factory(problem, device=..., **kwargs) -> FederatedSolver
SolverFactory = Callable[..., FederatedSolver]

#: defaults() -> dict of factory kwargs
DefaultsFn = Callable[[], Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    factory: SolverFactory
    layout: str = "sparse"
    defaults: Optional[DefaultsFn] = None
    description: str = ""


_REGISTRY: Dict[str, SolverSpec] = {}


def register(name: str, *, layout: str = "sparse",
             defaults: Optional[DefaultsFn] = None, description: str = ""):
    """Decorator registering a solver factory under ``name``."""
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}")

    def deco(factory: SolverFactory) -> SolverFactory:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = SolverSpec(name=name, factory=factory,
                                     layout=layout, defaults=defaults,
                                     description=description)
        return factory

    return deco


def _populate() -> None:
    """Import the algorithm modules so their ``register`` calls run."""
    import repro_torch.core.baselines  # noqa: F401  (gd)
    import repro_torch.core.cocoa      # noqa: F401  (cocoa, primal, dual)
    import repro_torch.core.dane       # noqa: F401  (dane, dane_ridge)
    import repro_torch.core.fedavg     # noqa: F401  (fedavg)
    import repro_torch.core.fsvrg      # noqa: F401  (fsvrg, svrg_naive)


def get_spec(name: str) -> SolverSpec:
    _populate()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown solver {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def make_solver(name: str, problem: FederatedLogReg, *,
                device: DeviceLike = None, **overrides) -> FederatedSolver:
    """Construct a registered solver on ``problem``; ``overrides`` replace
    the spec's defaults key by key."""
    spec = get_spec(name)
    kwargs = dict(spec.defaults()) if spec.defaults is not None else {}
    kwargs.update(overrides)
    return spec.factory(problem, device=device, **kwargs)


def available() -> tuple:
    """All registered solver names, sorted."""
    _populate()
    return tuple(sorted(_REGISTRY))
