"""numpy → port: turn another implementation's arrays into the port's
dataset and solver state on a chosen device.

The tests build the same problem in both packages by handing the
reference's ``FederatedDataset`` (numpy arrays) to :func:`dataset_from_arrays`
and the reference's iterate and per-client state to
:func:`state_from_array`, and the same fleet by handing its ``FleetTrace``
and ``DeltaFaults`` (plain dataclasses) to :func:`trace_from_config` and
:func:`faults_from_config`.  Anything with the same attribute names works:
nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.solver import SolverState
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fleet.faults import DeltaFaults
from repro_torch.fleet.traces import FleetTrace
from repro_torch.utils.device import DeviceLike, resolve_device


def tensor_from_array(a, dtype: torch.dtype,
                      device: DeviceLike = None) -> torch.Tensor:
    """A copy of array ``a`` as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=resolve_device(device))


def dataset_from_arrays(ds, device: DeviceLike = None) -> FederatedDataset:
    """``ds``: an object with a ``FederatedDataset``'s numpy fields (``idx``,
    ``val``, ``y``, ``client_of``, ``client_sizes``, ``num_features`` and the
    ``test_*`` arrays)."""
    dev = resolve_device(device)
    i64, f32 = torch.int64, torch.float32
    return FederatedDataset(
        idx=tensor_from_array(ds.idx, i64, dev),
        val=tensor_from_array(ds.val, f32, dev),
        y=tensor_from_array(ds.y, f32, dev),
        client_of=tensor_from_array(ds.client_of, i64, dev),
        client_sizes=np.asarray(ds.client_sizes, np.int32).copy(),
        num_features=int(ds.num_features),
        test_idx=tensor_from_array(ds.test_idx, i64, dev),
        test_val=tensor_from_array(ds.test_val, f32, dev),
        test_y=tensor_from_array(ds.test_y, f32, dev),
        test_client_of=tensor_from_array(ds.test_client_of, i64, dev),
    )


def state_from_array(w, round_index: int = 0, device: DeviceLike = None, *,
                     aux=()) -> SolverState:
    """A solver's state at iterate ``w`` and round ``round_index``; ``aux``
    is the per-client state as one array per bucket (CoCoA+'s α blocks),
    or () for a stateless solver."""
    return SolverState(
        w=tensor_from_array(w, torch.float32, device),
        aux=tuple(tensor_from_array(a, torch.float32, device) for a in aux),
        round=int(round_index))


def _fields_of(cls, cfg) -> dict:
    """``cfg``'s values of the fields of dataclass ``cls``."""
    src = (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
           else vars(cfg))
    return {f.name: src[f.name] for f in dataclasses.fields(cls)}


def trace_from_config(trace) -> FleetTrace:
    """The port's :class:`FleetTrace` with ``trace``'s fields."""
    return FleetTrace(**_fields_of(FleetTrace, trace))


def faults_from_config(faults) -> DeltaFaults:
    """The port's :class:`DeltaFaults` with ``faults``'s fields."""
    return DeltaFaults(**_fields_of(DeltaFaults, faults))
