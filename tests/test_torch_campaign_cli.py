"""The port's campaign command (``python -m repro_torch.experiments
.campaign``), the twin of ``benchmarks/campaign.py``, on the CPU: its
``--smoke``, ``--fault-smoke`` and ``--verify-resume`` modes exit 0, a
``--stop-after`` run resumes, the JSON goes only where ``--json`` says,
a resume mismatch exits 1, and without ``--device cpu`` it needs the card.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.experiments import campaign  # noqa: E402


def _json_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".json") and "cells" not in d)


def test_smoke_verifies_the_resume(tmp_path, capsys):
    out = str(tmp_path / "smoke")
    assert campaign.main(["--smoke", "--device", "cpu", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "verify-resume: events MATCH (6 vs 6 rounds)" in text
    assert "verify-resume: fedavg final state bit-identical" in text
    assert "resume verification: PASS" in text
    assert _json_files(str(tmp_path)) == [
        "smoke/summary.json", "smoke/verify_ref/summary.json",
        "smoke/verify_run/summary.json"]


def test_fault_smoke_rolls_back_and_converges(tmp_path, capsys):
    js = str(tmp_path / "fault.json")
    assert campaign.main(["--fault-smoke", "--device", "cpu", "--out",
                          str(tmp_path / "fs"), "--json", js]) == 0
    assert "-> PASS" in capsys.readouterr().out
    with open(js) as f:
        payload = json.load(f)
    assert payload["cells"]["gd"]["rollbacks"] >= 1
    assert payload["spec"]["faults"]["nan_rate"] == 0.4
    assert "finals" not in payload


def test_verify_resume_writes_its_json(tmp_path, capsys):
    js = str(tmp_path / "c.json")
    assert campaign.main(["--device", "cpu", "--out", str(tmp_path / "v"),
                          "--scale", "0.002", "--rounds", "3", "--algos",
                          "gd", "--verify-resume", "--json", js]) == 0
    with open(js) as f:
        payload = json.load(f)
    assert payload["resume_verified"] is True
    assert payload["spec"]["scale"] == 0.002
    assert payload["cells"]["gd"]["rounds"] == 3
    assert "verify-resume: gd final state bit-identical" in (
        capsys.readouterr().out)


def test_stop_after_then_resume(tmp_path, capsys):
    argv = ["--device", "cpu", "--out", str(tmp_path / "r"), "--scale",
            "0.002", "--rounds", "3", "--algos", "gd", "--checkpoint-every",
            "1", "--participation-model", "bernoulli"]
    assert campaign.main(argv + ["--stop-after", "2"]) == 0
    assert "stopped after 2 rounds" in capsys.readouterr().out
    assert campaign.main(argv) == 0
    text = capsys.readouterr().out
    # the crash came in round 1's callback, before its checkpoint
    assert "[gd] resuming from round 1" in text
    assert "gd     : rounds=3" in text


def test_a_resume_mismatch_exits_one(tmp_path, monkeypatch):
    real = campaign.run_campaign
    calls = []

    def flaky(spec, out_dir, **kw):
        calls.append(out_dir)
        res = real(spec, out_dir, **kw)
        if len(calls) == 3:      # the resumed run writes a different event
            with open(os.path.join(out_dir, "events.jsonl"), "a") as f:
                f.write(json.dumps({"cell": "gd", "round": 9}) + "\n")
        return res

    monkeypatch.setattr(campaign, "run_campaign", flaky)
    assert campaign.main(["--device", "cpu", "--out", str(tmp_path / "m"),
                          "--scale", "0.002", "--rounds", "2", "--algos",
                          "gd", "--verify-resume"]) == 1


def test_the_command_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        campaign.main(["--smoke", "--out", str(tmp_path / "s")])
