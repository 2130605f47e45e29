"""The train CLI's ``--profile-dir`` on the CPU: a ``torch.profiler``
Chrome trace of steps 11–20 of a 21-step ``tiny_test`` run (96×128,
batch 1, to keep the run short), which names the operators it recorded
and the program's own spans (``train_call``, ``train.*``: the tracer is on
over the profiled steps), and the tracer's summary of those steps printed
beside it. On the card the same trace holds the device kernels
(``chip_smoke.py``'s ``diag`` phase reads the ROIAlign and region-scatter
kernels in it).
"""

import json

import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402

torch.set_num_threads(1)


def test_profile_dir_writes_a_trace_of_steps_11_to_20(tmp_path, capsys):
    train_cli.main(["--preset", "tiny_test", "--device", "cpu", "--iterations", "21",
                    "--image-size", "96x128", "--batch-size", "1",
                    "--snapshot-every", "21", "--log-every", "21",
                    "--profile-dir", str(tmp_path / "trace"), "--out",
                    str(tmp_path / "run")])
    path = tmp_path / "trace" / "trace_rank0.json"
    out = capsys.readouterr().out
    assert f"[profile] steps 11-20: {path}" in out
    assert sorted(p.name for p in (tmp_path / "trace").iterdir()) == ["trace_rank0.json"]
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)
    assert {"train_call", "train.stage", "train.draws", "train.step"} <= names
    line = next(ln for ln in out.splitlines() if ln.startswith("[profile] tracing summary: "))
    summary = json.loads(line.split(": ", 1)[1])
    assert summary["spans_ms"]["train_call"]["n"] == 10
    assert list(summary["stages_ms"]) == ["forward", "proposals", "targets", "heads",
                                          "backward", "optimizer"]
    assert summary["units"] == 10 and summary["stage_kinds"] == ["host"]


def test_profile_dir_without_enough_steps_writes_nothing(tmp_path):
    train_cli.main(["--preset", "tiny_test", "--device", "cpu", "--iterations", "2",
                    "--image-size", "96x128", "--batch-size", "1",
                    "--profile-dir", str(tmp_path / "trace"), "--out",
                    str(tmp_path / "run")])
    assert not (tmp_path / "trace").exists()
