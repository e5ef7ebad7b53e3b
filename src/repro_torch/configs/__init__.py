"""Run configurations of the port: the paper's §4 logistic-regression problem
and the FSVRG / GD run settings.

These are copies of the reference package's ``configs/gplus_logreg.py``,
``fsvrg_gplus.py`` and ``gd_gplus.py`` (the port imports nothing of the
reference), with the getters the main path needs.
"""
from __future__ import annotations

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


__all__ = ["LogRegConfig", "FSVRGRunConfig", "GDRunConfig",
           "get_logreg_config", "get_fsvrg_config", "get_gd_config"]
