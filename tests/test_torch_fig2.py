"""The port's Fig. 2 command against the reference's.

``benchmarks/fig2_convergence.py`` (loaded by file path) and
``repro_torch.experiments.fig2_convergence`` run once each, on the CPU, at
``--scale 0.001 --rounds 2 --opt-iters 100``: the same data and round keys
from seed 0, so every curve picks the same swept value and draws the same
permutations and samples.

Tolerances: each curve's f within rtol 1e-4 (the sigmoid ulp, XLA's fused
multiply-adds and summation order; observed ≤ 2.1e-7), its test error
within one test example, its swept value equal.  The constant and majority
errors are equal.  OPT's error is equal; its f is the loss at w* = 0 below
500 iterations, an f32 mean of n equal terms that XLA sums in another order
than torch, so it is held at rtol 1e-6 (observed 2.6e-7; the printed
f* = 0.69315 is the same).
"""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.experiments import fig2_convergence as port_fig2  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--scale", "0.001", "--rounds", "2", "--opt-iters", "100"]
CURVES = ("fsvrg", "fsvrgr", "gd", "dane", "cocoa", "fedavg")


def _reference_main():
    name = "reference_fig2_convergence"
    spec = importlib.util.spec_from_file_location(
        name, REPO / "benchmarks" / "fig2_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod              # dataclasses look their module up
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[name]
    return mod.main


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both commands' results, each read back from its JSON."""
    out = tmp_path_factory.mktemp("fig2")
    _reference_main()(ARGS + ["--json", str(out / "ref.json")])
    port_fig2.main(ARGS + ["--device", "cpu", "--json",
                           str(out / "port.json")])
    port = json.loads((out / "port.json").read_text())
    ref = json.loads((out / "ref.json").read_text())
    return ref, port


@pytest.fixture(scope="module")
def one_example():
    """An error of one test example at ARGS's scale."""
    from repro_torch.configs import get_logreg_config
    from repro_torch.data import generate
    return 1.0 / int(generate(get_logreg_config().scaled(0.001), 0,
                              device="cpu").test_y.shape[0])


@pytest.mark.parametrize("name", CURVES + ("oneshot",))
def test_curve_matches_the_reference(runs, one_example, name):
    ref, port = runs
    if name == "oneshot":
        pairs = [(port[name], ref[name])]
    else:
        assert port[name]["solver"] == ref[name]["solver"]
        assert port[name]["swept"] == ref[name]["swept"]
        assert len(port[name]["hist"]) == len(ref[name]["hist"]) == 2
        pairs = list(zip(port[name]["hist"], ref[name]["hist"]))
        hp, rhp = port[name]["hyperparams"], ref[name]["hyperparams"]
        shared = set(hp) & set(rhp)
        assert {k: hp[k] for k in shared} == {k: rhp[k] for k in shared}
    for got, expect in pairs:
        assert got["f"] == pytest.approx(expect["f"], rel=1e-4)
        assert abs(got["err"] - expect["err"]) <= one_example + 1e-12


def test_baselines_and_opt_match_the_reference(runs):
    ref, port = runs
    assert port["const_err"] == ref["const_err"]
    assert port["majority_err"] == ref["majority_err"]
    assert port["opt"]["err"] == ref["opt"]["err"]
    assert port["opt"]["f"] == pytest.approx(ref["opt"]["f"], rel=1e-6)
    assert port["config"] == ref["config"]


def test_json_has_the_references_keys(runs):
    """The reference's keys, and per curve the port's wall seconds,
    launches (none on the CPU: the plain versions run) and rounds to the
    10 % gap."""
    ref, port = runs
    assert set(ref) <= set(port)
    for name in CURVES:
        assert set(ref[name]) <= set(port[name])
        assert port[name]["launches"] == {}
        assert port[name]["seconds"] > 0
        assert port[name]["rounds_to_10pct_gap"] in (None, 1, 2)
    assert set(ref["oneshot"]) <= set(port["oneshot"])
