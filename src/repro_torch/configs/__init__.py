"""Run configurations of the port: the paper's §4 logistic-regression problem
and the run settings of Fig. 2's solvers (FSVRG, GD, FedAvg, DANE, CoCoA+).

These are copies of the reference package's ``configs/gplus_logreg.py``,
``fsvrg_gplus.py``, ``gd_gplus.py``, ``fedavg_gplus.py``, ``dane_gplus.py``
and ``cocoa_gplus.py`` (the port imports nothing of the reference), with the
getters the solvers' registry defaults read.
"""
from __future__ import annotations

from repro_torch.configs.cocoa_gplus import CoCoARunConfig
from repro_torch.configs.dane_gplus import DANERunConfig
from repro_torch.configs.fedavg_gplus import FedAvgRunConfig
from repro_torch.configs.fsvrg_gplus import FSVRGRunConfig
from repro_torch.configs.gd_gplus import GDRunConfig
from repro_torch.configs.gplus_logreg import LogRegConfig


def get_logreg_config() -> LogRegConfig:
    from repro_torch.configs import gplus_logreg
    return gplus_logreg.CONFIG


def get_fsvrg_config() -> FSVRGRunConfig:
    from repro_torch.configs import fsvrg_gplus
    return fsvrg_gplus.CONFIG


def get_gd_config() -> GDRunConfig:
    from repro_torch.configs import gd_gplus
    return gd_gplus.CONFIG


def get_fedavg_config() -> FedAvgRunConfig:
    from repro_torch.configs import fedavg_gplus
    return fedavg_gplus.CONFIG


def get_dane_config() -> DANERunConfig:
    from repro_torch.configs import dane_gplus
    return dane_gplus.CONFIG


def get_cocoa_config() -> CoCoARunConfig:
    from repro_torch.configs import cocoa_gplus
    return cocoa_gplus.CONFIG


__all__ = ["LogRegConfig", "FSVRGRunConfig", "GDRunConfig", "FedAvgRunConfig",
           "DANERunConfig", "CoCoARunConfig", "get_logreg_config",
           "get_fsvrg_config", "get_gd_config", "get_fedavg_config",
           "get_dane_config", "get_cocoa_config"]
