"""The paper's algorithms on the port's round engine — the whole of the
reference's algorithm layer.

  problem.py   — sparse logreg problem, flat view + ceil(log2 n_k) buckets;
                 build_virtual_problem (rows regenerated on demand);
                 build_dense_problem for ridge data on the engine
  scaling.py   — S_k / A sparsity statistics (§3.6.1)
  engine.py    — the round: masks, per-bucket client passes, aggregation;
                 the streamed, cohort and virtual rounds
  solver.py    — the FederatedSolver protocol over a SolverState
  registry.py  — make_solver("fsvrg", prob), defaults from repro_torch.configs
  trainer.py   — the Trainer.fit round-loop driver and sweep
  svrg.py      — Algorithm 1 (single-machine SVRG)
  fsvrg.py     — Algorithm 4 (the paper's method) and Algorithm 3
  baselines.py — distributed GD, one-shot averaging, FedAvg wrapper,
                 per-author majority vote
  fedavg.py    — Federated Averaging
  dane.py      — DANE (Algorithm 2): GD and Prop.-1 SVRG local solvers,
                 exact ridge solves
  cocoa.py     — CoCoA+ (local SDCA, dual blocks through round_with_state)
                 and Appendix A's Algorithms 5 and 6 (Theorem 5)
"""
from repro_torch.core.problem import (ClientBucket, FederatedLogReg,
                                      LogRegProblem, VirtualBucket,
                                      VirtualFlat, VirtualLayout,
                                      build_dense_problem, build_problem,
                                      build_test_problem,
                                      build_virtual_problem)
from repro_torch.core.engine import EngineConfig, RoundEngine, cohort_capacity
from repro_torch.core.solver import FederatedSolver, SolverState
from repro_torch.core.registry import (available, get_spec, make_solver,
                                       register)
from repro_torch.core.trainer import (FitResult, NonFiniteIterateError,
                                      Trainer, sweep)
from repro_torch.core.fsvrg import FSVRG, FSVRGConfig, naive_fsvrg_round
from repro_torch.core.baselines import DistributedGD
from repro_torch.core.fedavg import FedAvg, FedAvgConfig
from repro_torch.core.dane import DANE, DANEConfig, DANERidge, dane_svrg_round
from repro_torch.core.cocoa import (CoCoAConfig, CoCoAPlus, DualMethod,
                                    PrimalMethod)

__all__ = [
    "ClientBucket", "FederatedLogReg", "LogRegProblem", "VirtualBucket",
    "VirtualFlat", "VirtualLayout", "build_dense_problem", "build_problem",
    "build_test_problem", "build_virtual_problem", "EngineConfig",
    "RoundEngine", "cohort_capacity",
    "FederatedSolver", "SolverState", "available", "get_spec", "make_solver",
    "register", "FitResult", "NonFiniteIterateError", "Trainer", "sweep",
    "FSVRG", "FSVRGConfig", "naive_fsvrg_round", "DistributedGD", "FedAvg",
    "FedAvgConfig", "DANE", "DANEConfig", "DANERidge", "dane_svrg_round",
    "CoCoAPlus", "CoCoAConfig", "DualMethod", "PrimalMethod",
]
