"""Tree checkpoints (npz payload + json manifest) in the reference's
format, so that either package restores what the other saved.

A tree is nested dicts, lists and tuples with tensor leaves (numpy arrays
and numpy scalars are taken too); a bare tensor is a valid root.

Layout of ``<path>`` (manifest format v3, the reference's
``checkpoint/checkpoint.py``):

  * ``manifest.json`` — ``format_version`` 3, ``step``, ``metadata``,
    ``leaves`` (each leaf's dtype and shape), ``paths`` (JAX's ``keystr``
    spelling: ``['w']``, ``['aux'][0]``), ``key_paths`` (``[kind, key]``
    pairs: ``"d"`` a dict key, ``"s"`` a sequence index), ``arrays_file``
    and ``payload_crc32``; ``treedef`` is a description, never parsed;
  * ``arrays-<step:09d>.npz`` — leaf i as ``leaf_<i>``; bf16 leaves are
    stored as their ``uint16`` bits (npz has no bfloat16) and restored
    bit for bit;
  * ``treedef.json`` — the paths again, for inspection.

Leaves are numbered in JAX's flattening order: dict keys sorted, sequences
in order, so ``leaf_i`` names the same leaf in both packages.  An int dict
key keeps kind ``"d"``, so it comes back as a dict key and not as a list
index.

Saves are **atomic**: every file goes through a same-directory temp file,
``fsync`` and ``os.replace``; the payload goes first under a step-unique
name and the manifest last, so the manifest on disk always names a payload
written in full before it.  Superseded payloads are removed only after the
manifest is committed.  Restore verifies the payload's CRC-32 against the
manifest (:class:`ChecksumError` on a mismatch) and also reads v2
manifests (no CRC), v1 manifests (``paths`` only: int dict keys come back
as lists, as in the reference) and the pre-atomic ``arrays.npz``.
"""
from __future__ import annotations

import io
import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


class ChecksumError(RuntimeError):
    """The payload on disk does not match the checksum its manifest
    recorded at save time."""


def _flatten(node, path=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in JAX's order: dict keys sorted, sequences
    in order; ``None`` and empty containers hold no leaf."""
    if isinstance(node, dict):
        return [pair for k in sorted(node)
                for pair in _flatten(node[k], path + (("d", k),))]
    if isinstance(node, (list, tuple)):
        return [pair for i, x in enumerate(node)
                for pair in _flatten(x, path + (("s", i),))]
    if node is None:
        return []
    return [(path, node)]


def _keystr(path) -> str:
    """JAX's ``keystr`` of a key path: ``['w']``, ``[0]``."""
    return "".join(f"[{key!r}]" if kind == "d" else f"[{key}]"
                   for kind, key in path)


def _describe(node) -> str:
    """The tree's structure in the spelling of JAX's ``PyTreeDef``."""
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, tuple):
        inner = ", ".join(_describe(x) for x in node)
        return "(" + inner + ("," if len(node) == 1 else "") + ")"
    if isinstance(node, list):
        return "[" + ", ".join(_describe(x) for x in node) + "]"
    return "None" if node is None else "*"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype: str,
                device: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(
        np.array(arr, dtype=np.dtype(dtype), copy=True)).to(device)


def _replace_file(path: str, write_fn) -> None:
    """Write through a same-directory temp file, ``fsync``, then rename it
    over ``path``.  ``write_fn`` receives an open binary-mode file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, tree: Any, *, step: int = 0,
         metadata: Optional[Dict] = None) -> None:
    """Save ``tree`` under directory ``path`` as checkpoint ``step``."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    payload = {}
    index = []
    for i, (_, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        payload[f"leaf_{i}"] = arr
        index.append({"dtype": dtype, "shape": list(arr.shape)})
    arrays_file = f"arrays-{step:09d}.npz"
    # serialized once in memory, so the manifest records the checksum of
    # exactly the bytes written
    blob = io.BytesIO()
    np.savez(blob, **payload)
    payload_bytes = blob.getvalue()
    payload_crc32 = zlib.crc32(payload_bytes)
    _replace_file(os.path.join(path, arrays_file),
                  lambda f: f.write(payload_bytes))
    paths = [_keystr(p) for p, _ in flat]
    key_paths = [[list(entry) for entry in p] for p, _ in flat]
    manifest = {
        "treedef": f"PyTreeDef({_describe(tree)})",
        "step": step,
        "metadata": metadata or {},
        "leaves": index,
        "format_version": 3,
        "paths": paths,
        "key_paths": key_paths,
        "arrays_file": arrays_file,
        "payload_crc32": payload_crc32,
    }
    _replace_file(os.path.join(path, "treedef.json"),
                  lambda f: f.write(json.dumps(
                      {"paths": paths, "key_paths": key_paths}).encode()))
    # the manifest last: its replacement is the commit point
    _replace_file(os.path.join(path, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    # superseded payloads, after the commit: a crash here leaves an unused
    # file, never a broken checkpoint
    for name in os.listdir(path):
        stale = (name == "arrays.npz"
                 or (name.startswith("arrays-") and name.endswith(".npz")
                     and name != arrays_file))
        if stale:
            try:
                os.remove(os.path.join(path, name))
            except OSError:  # pragma: no cover - cleanup is advisory
                pass


def _build_from_key_paths(key_paths, leaves):
    if len(leaves) == 1 and not key_paths[0]:
        return leaves[0]                 # a bare leaf is the root
    root: Dict = {}
    for kp, leaf in zip(key_paths, leaves):
        node = root
        for kind, key in kp[:-1]:
            node = node.setdefault((kind, key), {})
        kind, key = kp[-1]
        node[(kind, key)] = leaf
    return _finish(root)


def _finish(node):
    """(kind, key)-keyed build dicts to containers: sequence kinds (``"s"``,
    ``"i"``) become lists in index order, the others dicts."""
    if not isinstance(node, dict):
        return node
    kinds = {kind for kind, _ in node}
    if kinds <= {"s", "i"}:
        idxs = sorted(key for _, key in node)
        if idxs != list(range(len(idxs))):
            raise ValueError(f"non-contiguous sequence indices: {idxs}")
        return [_finish(node[(kind, i)]) for i in idxs
                for kind in ("s", "i") if (kind, i) in node]
    if kinds & {"s", "i"}:
        raise ValueError("mixed sequence/dict keys at one tree node")
    return {key: _finish(v) for (_, key), v in node.items()}


def _set_path(root: Dict, keystr_path: str, value) -> None:
    """v1: place a leaf by its ``keystr``, ``[0]`` read as an int key."""
    keys = re.findall(r"\['([^']+)'\]|\[(\d+)\]", keystr_path)
    node = root
    flat_keys = [k or int(i) for k, i in keys]
    for k in flat_keys[:-1]:
        node = node.setdefault(k, {})
    node[flat_keys[-1]] = value


def _listify(node):
    """v1: int-keyed dicts back to lists."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            return [_listify(node[i]) for i in sorted(node)]
        return {k: _listify(v) for k, v in node.items()}
    return node


def restore(path: str, device: DeviceLike = None) -> Tuple[Any, Dict]:
    """The tree saved under ``path``, its leaves as tensors on ``device``
    (default: the CUDA card), and ``{"step", "metadata"}``.  Sequences come
    back as lists."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays_path = os.path.join(path, manifest.get("arrays_file",
                                                  "arrays.npz"))
    with open(arrays_path, "rb") as f:
        payload_bytes = f.read()
    expected_crc = manifest.get("payload_crc32")
    if expected_crc is not None:
        actual_crc = zlib.crc32(payload_bytes)
        if actual_crc != expected_crc:
            raise ChecksumError(
                f"checkpoint payload {arrays_path} is corrupt: "
                f"crc32 {actual_crc:#010x} != manifest's "
                f"{expected_crc:#010x} — the file was torn or bit-rotted "
                "after the atomic commit")
    with np.load(io.BytesIO(payload_bytes)) as data:
        leaves = [_from_numpy(data[f"leaf_{i}"], meta["dtype"], dev)
                  for i, meta in enumerate(manifest["leaves"])]
    info = {"step": manifest["step"], "metadata": manifest["metadata"]}
    if manifest.get("key_paths") is not None:
        return _build_from_key_paths(manifest["key_paths"], leaves), info
    paths = manifest["paths"]            # a v1 manifest
    if len(leaves) == 1 and paths[0] == "":
        return leaves[0], info
    root: Dict = {}
    for kp, leaf in zip(paths, leaves):
        _set_path(root, kp, leaf)
    return _listify(root), info
