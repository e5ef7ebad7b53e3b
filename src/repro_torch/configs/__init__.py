"""Run configurations of the port: the paper's §4 logistic-regression problem
and the scale paths' paper-K and virtual-K configs, the run settings of
Fig. 2's solvers (FSVRG, GD, FedAvg, DANE, CoCoA+), and the model stack's
architectures (``get_config('<arch-id>')``, ``ARCH_IDS``).

These are copies of the reference package's ``configs/gplus_logreg.py``,
``fsvrg_gplus.py``, ``gd_gplus.py``, ``fedavg_gplus.py``, ``dane_gplus.py``,
``cocoa_gplus.py``, ``base.py``, ``rwkv6_3b.py``, the dense attention
family's ``llama3_8b.py``, ``h2o_danube_1_8b.py``, ``codeqwen1_5_7b.py``
and ``granite_20b.py`` and the MoE family's ``phi3_5_moe_42b.py`` and
``dbrx_132b.py`` and the Mamba / attention / MoE hybrid's
``jamba_v0_1_52b.py`` (the port imports nothing of the reference), with
the getters the solvers' registry defaults and the model stack read.  Of
the reference's architectures RWKV-6, the four dense decoders, the two
MoE decoders and the hybrid are ported (the hybrid serves; its training
waits for the selective scan's backward); the encoder-decoder and vision
ones are known by name and raise ``NotImplementedError`` (ROADMAP A11).
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      MoEConfig)
from repro_torch.configs.cocoa_gplus import CoCoARunConfig
from repro_torch.configs.dane_gplus import DANERunConfig
from repro_torch.configs.fedavg_gplus import FedAvgRunConfig
from repro_torch.configs.fsvrg_gplus import FSVRGRunConfig
from repro_torch.configs.gd_gplus import GDRunConfig
from repro_torch.configs.gplus_logreg import LogRegConfig

#: arch id -> its module under configs/ (None: known to the reference, not
#: ported yet)
_MODULES: Dict[str, Optional[str]] = {
    "granite-20b": "granite_20b",
    "seamless-m4t-medium": None,
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-1b": None,
    "llama3-8b": "llama3_8b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-3b": "rwkv6_3b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
}

#: every architecture of the reference, ported or not
ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    if _MODULES[arch_id] is None:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP A11: the other "
            f"model families); ported: "
            f"{[a for a, m in _MODULES.items() if m is not None]}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_logreg_config() -> LogRegConfig:
    from repro_torch.configs import gplus_logreg
    return gplus_logreg.CONFIG


def get_paper_k_config() -> LogRegConfig:
    """§4's K = 10,000 client count with d and n_k cut (see gplus_logreg)."""
    from repro_torch.configs import gplus_logreg
    return gplus_logreg.PAPER_K_CONFIG


def get_virtual_k_config(num_clients: int) -> LogRegConfig:
    """The virtual-data config at a chosen K — the §1.2 "as many nodes as
    users" regime (see gplus_logreg)."""
    from repro_torch.configs import gplus_logreg
    return gplus_logreg.get_virtual_k_config(num_clients)


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


__all__ = ["ArchConfig", "InputShape", "MoEConfig", "INPUT_SHAPES",
           "ARCH_IDS", "get_config", "LogRegConfig", "FSVRGRunConfig",
           "GDRunConfig", "FedAvgRunConfig", "DANERunConfig",
           "CoCoARunConfig", "get_logreg_config", "get_paper_k_config",
           "get_virtual_k_config", "get_fsvrg_config",
           "get_gd_config", "get_fedavg_config", "get_dane_config",
           "get_cocoa_config"]
