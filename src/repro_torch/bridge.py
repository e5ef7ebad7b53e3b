"""numpy → port: turn another implementation's arrays into the port's
dataset, solver state, model parameters and decode cache on a chosen
device.

The tests build the same problem in both packages by handing the
reference's ``FederatedDataset`` (numpy arrays) to :func:`dataset_from_arrays`
and the reference's iterate and per-client state to
:func:`state_from_array`, and the same fleet by handing its ``FleetTrace``
and ``DeltaFaults`` (plain dataclasses) to :func:`trace_from_config` and
:func:`faults_from_config`.  The same model: the reference's parameter
pytree and decode cache as nested dicts of numpy arrays go to
:func:`params_from_tree` and :func:`cache_from_tree`.  Anything with the
same attribute names or keys works: nothing here imports the reference.

Port → numpy, for the comparisons of training: :func:`tree_from_params`
turns parameters, or gradients keyed as ``named_parameters()`` keys them,
back into the reference's stacked pytree (:func:`tensor_tree_from_params`:
the same tree of tensors in their own dtype, which checkpoints save), and
:func:`batch_from_arrays` turns a token batch of numpy arrays into the
port's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.solver import SolverState
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fleet.faults import DeltaFaults
from repro_torch.fleet.traces import FleetTrace
from repro_torch.models.model import LMParams, Model
from repro_torch.models.transformer import Layer
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


def tensor_like_array(a, device: DeviceLike = None) -> torch.Tensor:
    """A copy of array ``a`` with its own dtype (bfloat16 included, which
    numpy holds as an extension type) as a tensor on ``device``; a tensor
    is copied to ``device`` as it is."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.detach().to(dev, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_tree(tree: Mapping, model: Model) -> LMParams:
    """The port's parameters of ``model`` from the reference's decoder-only
    pytree: ``embed``, ``out_norm``, ``unembed`` and ``layers/pos{j}/...``
    with a leading (num_layers // P) axis; layer i = rep · P + j becomes
    the i-th :class:`Layer`.  Each leaf keeps its dtype.  Leaves may be
    numpy arrays or tensors (a tree from :func:`repro_torch.checkpoint
    .restore`)."""
    dev = model.device
    emb = {k: tensor_like_array(v, dev) for k, v in tree.items()
           if k != "layers"}
    stacked = tree["layers"]
    P = len(stacked)
    nrep = model.cfg.num_layers // P

    def leaf(x, rep):
        if isinstance(x, Mapping):
            return {k: leaf(v, rep) for k, v in x.items()}
        return tensor_like_array(
            x[rep] if isinstance(x, torch.Tensor) else np.asarray(x)[rep],
            dev)

    layers = torch.nn.ModuleList(
        Layer(leaf(stacked[f"pos{i % P}"], i // P))
        for i in range(nrep * P))
    return LMParams(emb, layers)


def cache_from_tree(tree: Mapping, device: DeviceLike = None) -> Dict:
    """The port's decode cache from the reference's: ``len`` and
    ``pos{j}/{wkv, shift_tm, shift_cm}`` (RWKV), ``pos{j}/{ssm, conv}``
    (Mamba) or ``pos{j}/{k, v}`` (attention) with a leading (nrep,) axis
    become ``{"len": int, "layers": [per-layer dict]}`` (layer i = rep · P
    + j); each leaf keeps its dtype."""
    P = sum(1 for k in tree if k != "len")
    nrep = len(np.asarray(next(iter(tree["pos0"].values()))))
    layers = [{k: tensor_like_array(np.asarray(v)[i // P], device)
               for k, v in tree[f"pos{i % P}"].items()}
              for i in range(nrep * P)]
    return {"len": int(np.asarray(tree["len"])), "layers": layers}


def _stacked_tree(named: Mapping[str, torch.Tensor], leaf) -> Dict:
    """``named`` (keyed as ``named_parameters()``) in the reference's
    decoder-only layout: ``embed``, ``out_norm``, ``unembed`` and
    ``layers/pos{j}/...`` for the P positions of a pattern block, each with
    a leading (num_layers // P,) axis (layer i = rep · P + j); P is the
    period of the layers' parameter names (1 for a stack of one kind, 8
    for the Jamba hybrid's); ``leaf`` turns a list of per-layer tensors
    (or one tensor, ``stack=False``) into a leaf."""
    tree: Dict = {k: leaf([v], stack=False) for k, v in named.items()
                  if "." not in k}
    per_layer: Dict[int, Dict] = {}
    for key, v in named.items():
        if "." in key:
            _, i, *path = key.split(".")
            per_layer.setdefault(int(i), {})[tuple(path)] = v
    n = len(per_layer)
    P = next(p for p in range(1, n + 1)
             if n % p == 0 and all(per_layer[i].keys() == per_layer[i % p]
                                   .keys() for i in range(n)))
    tree["layers"] = {}
    for j in range(P):
        pos: Dict = {}
        for path in per_layer[j]:
            node = pos
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaf([per_layer[i][path]
                                   for i in range(j, n, P)], stack=True)
        tree["layers"][f"pos{j}"] = pos
    return tree


def _named(params: Union[LMParams, Mapping[str, torch.Tensor]]) -> Dict:
    return (dict(params.named_parameters())
            if isinstance(params, torch.nn.Module) else dict(params))


def tree_from_params(params: Union[LMParams, Mapping[str, torch.Tensor]]
                     ) -> Dict:
    """The inverse of :func:`params_from_tree`: ``embed``, ``out_norm``,
    ``unembed`` and ``layers/pos{j}/...`` with a leading (num_layers // P,)
    axis, as numpy arrays.  ``params``: an :class:`LMParams`, or any
    mapping keyed as its ``named_parameters()`` (gradients, an
    optimizer's new tensors).  bf16
    leaves come back as f32 arrays (numpy has no bf16; the widening is
    exact)."""

    def array(ts, stack):
        ts = [t.detach().cpu() for t in ts]
        ts = [t.float() if t.dtype == torch.bfloat16 else t for t in ts]
        return (np.stack([t.numpy() for t in ts]) if stack
                else ts[0].numpy())

    return _stacked_tree(_named(params), array)


def tensor_tree_from_params(params: Union[LMParams,
                                          Mapping[str, torch.Tensor]]
                            ) -> Dict:
    """:func:`tree_from_params`'s layout with tensor leaves in their own
    dtype (bf16 stays bf16), on the parameters' device — what
    ``launch/train.py --checkpoint-dir`` saves, as the reference saves its
    parameter tree."""

    def tensor(ts, stack):
        ts = [t.detach() for t in ts]
        return torch.stack(ts) if stack else ts[0]

    return _stacked_tree(_named(params), tensor)


def batch_from_arrays(batch: Mapping, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """A token batch (``tokens``, ``labels``, ``mask`` and the like, of any
    leading shape, e.g. a round's (C, T, B_c, S)) as tensors on
    ``device``: integer arrays as int64, the rest as f32."""
    dev = resolve_device(device)
    out = {}
    for k, a in batch.items():
        a = np.asarray(a)
        dtype = (torch.int64 if np.issubdtype(a.dtype, np.integer)
                 else torch.float32)
        out[k] = tensor_from_array(a, dtype, dev)
    return out
