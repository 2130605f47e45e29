"""The benchmark's files, found by name: ``BENCHMARK.json`` at the
checkout's root, ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py`` and ``metrics/<metric>.py``; and the configuration
objects built from a configuration file, for the program and for the
reference alike."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# sections of a configuration file that set fields of the config object
SECTIONS = ("model", "anchors", "proposals", "sampler", "anchor_targets",
            "train", "eval")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` joined with its own file; for
    a cell held out of ``BENCHMARK.json`` (PERF.md §7), whose file carries
    the entry's ``config``, ``traffic`` and ``chips`` itself, the file."""
    spec = benchmark()
    entries = [w for w in spec["workloads"] if w["name"] == name]
    path = HERE / "workloads" / f"{name}.json"
    held = load_json(path) if not entries and path.exists() else {}
    if not entries and "traffic" not in held:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    return {**(entries[0] if entries else {"name": name}), **load_json(path)}


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def metrics_of(name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those without a ``workloads`` key and those that list the cell."""
    spec = benchmark()
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def _typed(value):
    return tuple(_typed(v) for v in value) if isinstance(value, list) else value


def build_config(config_module, file: dict, *overrides: dict):
    """``config_module.PRESETS[file["preset"]]()`` with every section of the
    file (and then of each of ``overrides``) applied, lists as tuples."""
    cfg = config_module.PRESETS[file["preset"]]()
    for source in (file, *overrides):
        for section in SECTIONS:
            if section in source:
                changes = {k: _typed(v) for k, v in source[section].items()}
                cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
                    getattr(cfg, section), **changes)})
    return cfg


def traffic(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")
