"""Run one cell of the benchmark once and print one JSON line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic; ``benchmark/workloads/<cell>.json`` holds
the traffic's parameters and the limits of the numbers that decide
``correct``; ``benchmark/traffic/<kind>.py`` sets up the program, opens
the window, serves or trains for ``--seconds``, closes it, and compares
with the reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones (each read by ``benchmark/metrics/<name>.py``
from traced stretches after the window) with the device's busy and
window seconds and a breakdown. Without enough CUDA devices, or with JAX
loaded once the window has closed, it prints no result and exits 2.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "maskrcnn_tpu")
CACHE_DIR = spec.ROOT / ".bench_cache"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


class Run:
    """One run's settings and what it has read so far; handed to the
    traffic's ``run``."""

    def __init__(self, args, device: str = "cuda", overrides: dict | None = None):
        self.work = spec.workload(args.workload)
        self.name = args.workload
        self.config = spec.config_file(self.work["config"])
        self.overrides = overrides or {}
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = device
        self.window_open = None
        self.reserved_peak = 0
        self.phases = {}
        self.fault = None  # a fault that benchmark.control plants in a rank
        self.forbidden_elsewhere = set()  # what the run's other processes loaded

    def mark(self, phase: str):
        """Record when a phase of set-up ended, in seconds from the start
        of the process."""
        self.phases[phase] = time.perf_counter() - PROCESS_START

    def program_config(self, *more: dict):
        from maskrcnn_tpu_torch import config as program_config
        return spec.build_config(program_config, self.config, self.overrides, *more)

    def reference_config(self, *more: dict):
        from benchmark.reference import config as reference_config
        return spec.build_config(reference_config, self.config, self.overrides, *more)

    def open_window(self):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.window_open = time.perf_counter()
        return self.window_open

    def window_closed(self):
        """Read the device's memory peaks before anything else runs."""
        import torch
        if self.device == "cuda":
            self.reserved_peak = max(torch.cuda.max_memory_reserved(i)
                                     for i in range(torch.cuda.device_count()))


def load_reader(name: str):
    path = spec.HERE / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def per_layer(run: Run, readings) -> dict:
    out = {}
    for m in spec.metrics_of(run.name, trace=True):
        value = load_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(run: Run) -> dict:
    """Set up, measure, compare → the result line's fields (``device``
    without the card's name)."""
    result = spec.traffic(run.work["traffic"]).run(run)
    if run.trace:
        metrics = per_layer(run, result["readings"])
    else:
        units = {m["name"]: m["unit"] for m in spec.metrics_of(run.name, False)}
        metrics = {name: {"value": value, "unit": units[name]}
                   for name, value in result["end_to_end"].items() if name in units}
        metrics["setup_s"] = {"value": run.window_open - PROCESS_START, "unit": "s"}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": {"memory_peak_bytes": run.reserved_peak}}
    if run.trace:
        graphed = result["readings"].graphed
        busy_s = result.get("busy_s") or graphed.busy_s()  # over the ranks
        line["device"].update(busy_s=busy_s, window_s=graphed.wall_s)
        line["breakdown"] = result["breakdown"]
    line["checked"] = {**result["checked"], "setup_phases": run.phases}
    line["compared"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in result["compared"]}
    return line


def main(argv=None):
    args = parse_args(argv)
    # kernel caches at fixed paths inside the checkout: only a checkout's
    # first run fills them
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE_DIR / "inductor")
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    run = Run(args)
    chips = int(run.work.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {run.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = bool(run.config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(run.config.get("tf32", False))
    line = execute(run)
    found = sorted(set(forbidden_modules()) | run.forbidden_elsewhere)
    if found:
        print(f"benchmark: loaded in this process or its ranks: {', '.join(found)}",
              file=sys.stderr)
        sys.exit(2)
    line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": chips, **line["device"]}
    for name, row in line["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    compared = line.pop("compared")
    line["compared"] = compared  # last in the line
    print(json.dumps(line))


if __name__ == "__main__":
    main()
