"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same manifest-v3 files, so either
package restores what the other saved, bit for bit.

Trees: a solver state (f32 ``w``, an aux tuple, a 0-d int32 round), an
empty aux, int dict keys, a bare root, bf16 leaves, nested lists and
tuples.  Each goes both ways — the reference's ``save`` read by the port's
``restore`` and the port's ``save`` read by the reference's — and the two
manifests must agree field by field (all but the CRC, which covers the
zip's timestamps).  Then the reference's atomic-save and manifest-version
cases (``tests/test_campaign.py``) on the port, with the files of each
version written by either package; and ``launch/train.py
--checkpoint-dir`` against the reference's parameter tree.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro import checkpoint as ref_checkpoint  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch import bridge, checkpoint  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def _trees(rng):
    """name -> the same tree as numpy arrays (bf16 as uint16 bits plus a
    mark) for both packages."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf16 = lambda *s: ("bf16", rng.integers(0, 1 << 16, s,  # noqa: E731
                                            dtype=np.uint16)
                       & np.uint16(0x7F7F))   # finite bit patterns
    return {
        "solver_state": {"w": f32(7), "aux": (f32(3, 4), f32(2, 4)),
                         "round": np.asarray(5, np.int32)},
        "empty_aux": {"w": f32(7), "aux": (),
                      "round": np.asarray(0, np.int32)},
        "int_keys": {"table": {10: f32(2), 3: f32(3), 2: np.arange(
            4, dtype=np.int32)}, "w": f32(1)},
        "bare_root": f32(4, 3),
        "bf16": {"emb": bf16(4, 6), "layers": [bf16(2, 3), f32(3)],
                 "norm": bf16(5)},
        "nested": {"b": [f32(2), (f32(1), [np.float32(2.5)])],
                   "a": {"z": np.asarray([1, 2], np.int32), "y": f32(0)}},
    }


def _is_bf16(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)


def _map(tree, leaf):
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, leaf) for v in tree]
    if isinstance(tree, tuple) and not _is_bf16(tree):
        return tuple(_map(v, leaf) for v in tree)
    return leaf(tree)


def _as_jax(x):
    """The reference's leaf: bf16 as a jax array, the rest numpy (jax
    without x64 would narrow an f64 leaf)."""
    if _is_bf16(x):
        return jax.lax.bitcast_convert_type(jnp.asarray(x[1]), jnp.bfloat16)
    return x


def _as_torch(x):
    if _is_bf16(x):
        return torch.from_numpy(x[1].view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _bits(x):
    """A restored leaf of either package as (dtype name, raw bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
        return x.dtype.name, x
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return "bfloat16", x.view(np.uint16)
    return x.dtype.name, x


def _expect_bits(x):
    if _is_bf16(x):
        return "bfloat16", x[1]
    x = np.asarray(x)
    return x.dtype.name, x


def _same(got, expect):
    """Restored tree ``got`` equals the saved ``expect``: sequences come
    back as lists, dict keys keep their type, leaves bit for bit."""
    if isinstance(expect, dict):
        assert isinstance(got, dict) and list(got) == sorted(expect)
        for k in expect:
            _same(got[k], expect[k])
    elif isinstance(expect, list) or (isinstance(expect, tuple)
                                      and not _is_bf16(expect)):
        assert isinstance(got, list) and len(got) == len(expect)
        for g, e in zip(got, expect):
            _same(g, e)
    else:
        gd, gb = _bits(got)
        ed, eb = _expect_bits(expect)
        assert gd == ed and gb.shape == eb.shape
        np.testing.assert_array_equal(gb, eb)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    m.pop("payload_crc32")
    return m


TREES = list(_trees(np.random.default_rng(0)))


@pytest.mark.parametrize("name", TREES)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_restore_across_the_packages(tmp_path, name, writer):
    tree = _trees(np.random.default_rng(0))[name]
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    meta = {"solver": "fsvrg", "seed": 3}
    ref_checkpoint.save(d_ref, _map(tree, _as_jax), step=7, metadata=meta)
    checkpoint.save(d_port, _map(tree, _as_torch), step=7, metadata=meta)
    assert _manifest(d_port) == _manifest(d_ref)
    if writer == "reference":
        got, info = checkpoint.restore(d_ref, "cpu")
    else:
        got, info = ref_checkpoint.restore(d_port)
    assert info == {"step": 7, "metadata": meta}
    if name == "empty_aux":          # an empty container holds no leaf
        assert "aux" not in got
        tree = {k: v for k, v in tree.items() if k != "aux"}
    _same(got, tree)


def test_restore_places_leaves_on_the_device_and_needs_one(tmp_path,
                                                          monkeypatch):
    d = str(tmp_path / "ck")
    checkpoint.save(d, {"w": torch.arange(3.0)}, step=1)
    tree, _ = checkpoint.restore(d, "cpu")
    assert tree["w"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.restore(d)


# --------------------------------------------------------------------- #
# the atomic protocol and the manifest versions (tests/test_campaign.py)
# --------------------------------------------------------------------- #


def _tree(v):
    return {"w": torch.arange(4, dtype=torch.float32) * v,
            "round": torch.tensor(v, dtype=torch.int32)}


def _save(writer, d, v):
    if writer == "port":
        checkpoint.save(d, _tree(v), step=v)
    else:
        ref_checkpoint.save(d, {"w": np.arange(4, dtype=np.float32) * v,
                                "round": np.int32(v)}, step=v)


def _restored_step(d, v):
    tree, info = checkpoint.restore(d, "cpu")
    assert info["step"] == v
    assert torch.equal(tree["w"], _tree(v)["w"])
    assert torch.equal(tree["round"], _tree(v)["round"])


def test_checkpoint_interrupted_payload_write_keeps_previous(tmp_path,
                                                             monkeypatch):
    d = str(tmp_path / "ck")
    checkpoint.save(d, _tree(1), step=1)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    with pytest.raises(OSError):
        checkpoint.save(d, _tree(2), step=2)
    monkeypatch.undo()
    _restored_step(d, 1)


def test_checkpoint_interrupted_before_manifest_keeps_previous(tmp_path,
                                                               monkeypatch):
    """A kill between the payload write and the manifest's replace: the new
    payload is on disk, the manifest (the commit point) still names the
    old one."""
    d = str(tmp_path / "ck")
    checkpoint.save(d, _tree(1), step=1)
    real_replace = os.replace

    def replace_except_manifest(src, dst):
        if os.path.basename(dst) == "manifest.json":
            raise OSError("killed before commit")
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt_mod.os, "replace", replace_except_manifest)
    with pytest.raises(OSError):
        checkpoint.save(d, _tree(2), step=2)
    monkeypatch.undo()
    assert "arrays-000000002.npz" in os.listdir(d)
    _restored_step(d, 1)


def test_checkpoint_completed_save_cleans_stale_payloads(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, _tree(1), step=1)
    checkpoint.save(d, _tree(2), step=2)
    payloads = [f for f in os.listdir(d) if f.endswith(".npz")]
    assert payloads == ["arrays-000000002.npz"]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    _restored_step(d, 2)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_legacy_arrays_npz(tmp_path, writer):
    """Pre-atomic checkpoints (a plain arrays.npz, no arrays_file key)."""
    d = str(tmp_path / "ck")
    _save(writer, d, 3)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    os.rename(os.path.join(d, manifest.pop("arrays_file")),
              os.path.join(d, "arrays.npz"))
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    _restored_step(d, 3)
    checkpoint.save(d, _tree(4), step=4)     # the legacy payload goes
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "arrays-000000004.npz"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_checksum_detects_corruption(tmp_path, writer):
    d = str(tmp_path / "ck")
    _save(writer, d, 1)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 3 and "payload_crc32" in manifest
    path = os.path.join(d, manifest["arrays_file"])
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(checkpoint.ChecksumError, match="crc32"):
        checkpoint.restore(d, "cpu")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_pre_v3_manifest_without_crc_restores(tmp_path, writer):
    """A v2 manifest (no payload_crc32) restores unverified."""
    d = str(tmp_path / "ck")
    _save(writer, d, 4)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    del manifest["payload_crc32"]
    manifest["format_version"] = 2
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    _restored_step(d, 4)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_v1_manifest_restores_through_keystr(tmp_path, writer):
    """A v1 manifest (``paths`` only): the keystr fallback, in which an
    int dict key reads as a list index — as the reference reads it — and a
    bare root as the root."""
    tree = {"t": {0: np.float32([1, 2]), 1: np.float32([3])},
            "w": np.arange(3, dtype=np.float32)}
    for name, saved in (("dict", tree), ("bare", np.float32([7, 8]))):
        d = str(tmp_path / name)
        if writer == "port":
            checkpoint.save(d, saved, step=2)
        else:
            ref_checkpoint.save(d, saved, step=2)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        for k in ("key_paths", "payload_crc32"):
            del manifest[k]
        manifest["format_version"] = 1
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        got, info = checkpoint.restore(d, "cpu")
        ref_got, _ = ref_checkpoint.restore(d)
        assert info["step"] == 2
        if name == "bare":
            assert torch.equal(got, torch.tensor([7.0, 8.0]))
            continue
        assert isinstance(got["t"], list) and isinstance(ref_got["t"], list)
        for g, e in zip(got["t"] + [got["w"]], ref_got["t"] + [ref_got["w"]]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))


# --------------------------------------------------------------------- #
# launch/train.py --checkpoint-dir and the parameter tree
# --------------------------------------------------------------------- #


def test_train_checkpoint_dir_saves_the_references_parameter_tree(tmp_path):
    """The port's driver saves its final parameters in the reference's tree
    layout: the reference restores them, with the metadata and step the
    reference's driver writes, and they equal the port's parameters."""
    d = str(tmp_path / "ck")
    train.main(["--device", "cpu", "--mode", "fedavg", "--rounds", "1",
                "--seq", "32", "--checkpoint-dir", d])
    tree, info = ref_checkpoint.restore(d)
    assert info == {"step": 1, "metadata": {"arch": "rwkv6-3b-reduced",
                                            "mode": "fedavg"}}
    ref_cfg = ref_get_config("rwkv6-3b").reduced()
    ref_tree = ref_build_model(ref_cfg, jnp.float32).init(
        jax.random.PRNGKey(0))
    flat = lambda t: {jax.tree_util.keystr(k): v  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, shapes = flat(tree), flat(ref_tree)
    assert got.keys() == shapes.keys()
    for k in got:
        assert got[k].shape == shapes[k].shape and got[k].dtype == jnp.float32
    model = build_model(get_config("rwkv6-3b").reduced(), torch.float32,
                        device="cpu")
    port_tree, _ = checkpoint.restore(d, "cpu")
    back = bridge.tree_from_params(bridge.params_from_tree(port_tree, model))
    for k, v in flat(back).items():
        np.testing.assert_array_equal(v, np.asarray(got[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_parameter_checkpoint_restores_into_the_port(tmp_path,
                                                              dtype):
    """The reference's reduced rwkv6-3b parameters saved by the reference
    and restored by the port, through ``bridge.params_from_tree``: the
    same bits in every leaf, and in f32 the reference's loss (1e-6
    relative, as ``tests/test_torch_train.py`` holds it)."""
    ref_cfg = ref_get_config("rwkv6-3b").reduced()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = ref_build_model(ref_cfg, jdt)
    jp = jm.init(jax.random.PRNGKey(0))
    d = str(tmp_path / "ck")
    ref_checkpoint.save(d, jp, step=3, metadata={"arch": ref_cfg.name})
    tree, info = checkpoint.restore(d, "cpu")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pm = build_model(get_config("rwkv6-3b").reduced(), tdt, device="cpu")
    pp = bridge.params_from_tree(tree, pm)
    saved = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    port_tree = bridge.tensor_tree_from_params(pp)
    restored = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(port_tree)[0]}
    assert saved.keys() == restored.keys()
    dtypes = set()
    for k, v in saved.items():
        gd, gb = _bits(restored[k])
        ed, eb = _bits(v)
        assert gd == ed, k
        np.testing.assert_array_equal(gb, eb, err_msg=k)
        dtypes.add(gd)
    assert dtype in dtypes      # (the norms stay f32 in a bf16 model)
    if dtype == "bfloat16":
        return
    rng = np.random.default_rng(1)
    toks = rng.integers(0, pm.cfg.vocab_size, size=(2, 33))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32),
         "mask": np.ones((2, 32), np.float32)}
    jl, _ = jm.loss(jp, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        tl, _ = pm.loss(pp, bridge.batch_from_arrays(b, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
