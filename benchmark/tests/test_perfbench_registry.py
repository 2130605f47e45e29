"""``BENCHMARK.json`` and the files it names: every cell names a
configuration, a traffic kind and limits that exist, every per-layer
metric has its reader, and the file keeps to the contract's shapes."""

import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_what_exists(cell):
    work = spec.workload(cell)
    names = {c["name"] for c in BENCH["configs"]}
    assert work["config"] in names
    assert (spec.HERE / "traffic" / f"{work['traffic']}.py").exists()
    assert work["chips"] in (1, 4)
    assert len(work["why"]) <= 200
    assert work["limits"], "every cell compares numbers with limits"
    assert spec.metrics_of(cell, trace=True), "a per-layer metric a cell"
    e2e = {m["name"] for m in spec.metrics_of(cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader(metric):
    from benchmark.run import load_reader

    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(load_reader(metric))
    assert set(entry["workloads"]) <= set(CELLS)
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    assert set(entry["workloads"]) <= set(moves.get("workloads", CELLS))


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in metrics + BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_builds_for_both_sides(config):
    from maskrcnn_tpu_torch import config as program_config

    from benchmark.reference import config as ref_config

    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    file = spec.load_json(spec.ROOT / entry["file"])
    assert file["source"] == entry["source"]
    assert spec.build_config(program_config, file) == spec.build_config(
        program_config, file)
    p = spec.build_config(program_config, file)
    r = spec.build_config(ref_config, file)
    assert repr(p) == repr(r)


def test_without_a_card_the_run_prints_nothing_and_fails():
    import os
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(spec.ROOT), "BENCH_RUN": "x"})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
