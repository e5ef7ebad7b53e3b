"""The port stands alone, and runs on the card unless asked not to.

``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the
reference package — the machine with the card has no JAX — and every
entry point raises without CUDA unless the caller passes ``device="cpu"``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_logreg_config  # noqa: E402
from repro_torch.examples import federated_lm  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.core import (available, build_dense_problem,  # noqa: E402
                              build_problem, get_spec, make_solver)
from repro_torch.data import generate  # noqa: E402
from repro_torch.experiments import fig2_convergence  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert all(f.exists() for f in files)
    names = {f.relative_to(REPO / "src").as_posix() for f in files[:-1]}
    assert {"repro_torch/core/fedavg.py", "repro_torch/core/dane.py",
            "repro_torch/core/cocoa.py", "repro_torch/kernels/cocoa_sdca.py",
            "repro_torch/kernels/fedavg_update.py",
            "repro_torch/kernels/dane_update.py",
            "repro_torch/kernels/robust_aggregate.py",
            "repro_torch/utils/threefry.py", "repro_torch/fleet/traces.py",
            "repro_torch/fleet/participation.py",
            "repro_torch/fleet/faults.py", "repro_torch/kernels/wkv6.py",
            "repro_torch/models/rwkv.py", "repro_torch/models/model.py",
            "repro_torch/models/transformer.py",
            "repro_torch/launch/serve.py",
            "repro_torch/configs/rwkv6_3b.py", "repro_torch/core/neural.py",
            "repro_torch/optim/optimizers.py", "repro_torch/launch/steps.py",
            "repro_torch/launch/train.py",
            "repro_torch/examples/federated_lm.py",
            "repro_torch/core/svrg.py",
            "repro_torch/experiments/fig2_convergence.py",
            "repro_torch/checkpoint/checkpoint.py",
            "repro_torch/fleet/metrics.py", "repro_torch/fleet/campaign.py",
            "repro_torch/experiments/campaign.py"} <= names
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """Every registered solver, each on a problem of its spec's layout,
    and the Fig. 2 command."""
    cfg = get_logreg_config().scaled(0.001)
    ds = generate(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    Xs = [rng.standard_normal((5, 6)) for _ in range(3)]
    ys = [rng.standard_normal(6) for _ in range(3)]
    probs = {"sparse": build_problem(ds, device="cpu"),
             "dense": build_dense_problem(Xs, ys, 0.1, device="cpu")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_problem(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_dense_problem(Xs, ys, 0.1)
    for name in available():
        prob = probs[get_spec(name).layout]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_solver(name, prob)
        assert make_solver(name, prob, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig2_convergence.main(["--scale", "0.001", "--rounds", "1"])


def test_only_cpu_and_cuda_devices():
    prob = build_problem(generate(get_logreg_config().scaled(0.001), 0,
                                  device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        make_solver("gd", prob, device="meta")


def test_serving_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """build_model, the serve CLI and a generator's device: CUDA unless
    asked for the CPU."""
    cfg = get_config("rwkv6-3b").reduced()
    model = build_model(cfg, torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.zeros((1, 32), dtype=torch.int64)
    assert serve.serve(model, params, prompt, 2).tokens.shape == (1, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1", "--prompt-len", "32",
                    "--max-new", "2"])
    serve.main(["--requests", "1", "--prompt-len", "32", "--max-new", "2",
                "--device", "cpu"])


def test_training_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """The train CLI and the federated LM example: CUDA unless asked for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train.main, federated_lm.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--rounds", "1"])


def test_unported_architectures_name_the_roadmap():
    for arch in ("seamless-m4t-medium", "internvl2-1b"):
        with pytest.raises(NotImplementedError, match="A11"):
            get_config(arch)
    for arch in ("phi3.5-moe-42b-a6.6b", "dbrx-132b"):
        assert get_config(arch).name == arch
        assert get_config(arch).family == "moe"
    assert get_config("jamba-v0.1-52b").name == "jamba-v0.1-52b"
    assert get_config("jamba-v0.1-52b").family == "hybrid"
    with pytest.raises(KeyError):
        get_config("no-such-arch")
