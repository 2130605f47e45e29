"""``tools/bench_turns.py``: the bench from two checkouts in turns (other,
this, this, other), one JSON line a run, a failed run reported."""

import json

import pytest

pytest.importorskip("torch")

from maskrcnn_tpu_torch.tools import bench_turns  # noqa: E402


def test_runs_each_config_in_turns_and_reports_failures(tmp_path, monkeypatch, capsys):
    calls = []

    def fake(root, config):
        calls.append((root, config))
        if root == tmp_path and config == "predict":
            return {"error": "no GPU", "returncode": 1}
        return {"p50_ms": 1.0}

    monkeypatch.setattr(bench_turns, "run_bench", fake)
    out = tmp_path / "turns.jsonl"
    rc = bench_turns.main(["--other", str(tmp_path), "--out", str(out),
                           "--config", "train --preset tiny_test",
                           "--config", "predict"])
    assert rc == 1
    this = bench_turns.THIS
    assert calls == [(tmp_path, "train --preset tiny_test"),
                     (this, "train --preset tiny_test"),
                     (this, "train --preset tiny_test"),
                     (tmp_path, "train --preset tiny_test"),
                     (tmp_path, "predict"), (this, "predict"),
                     (this, "predict"), (tmp_path, "predict")]
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["checkout"] for r in rows] == ["other", "this", "this", "other"] * 2
    assert [r["turn"] for r in rows] == [0, 1, 2, 3] * 2
    assert rows[4]["result"]["error"] == "no GPU"
    assert capsys.readouterr().out.count("\n") == 8


def test_a_bench_without_a_card_is_an_error():
    """On this CPU-only machine the bench exits non-zero: the run is an
    error, not a number."""
    result = bench_turns.run_bench(bench_turns.THIS, "predict --preset tiny_test")
    assert "error" in result and result["returncode"] != 0
    assert "unrecognized arguments" not in result["error"]  # the mode went in
