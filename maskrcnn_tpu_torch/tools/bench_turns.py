"""Run ``maskrcnn_tpu_torch.bench`` from two checkouts in turns on one card.

    python -m maskrcnn_tpu_torch.tools.bench_turns --other DIR
        [--out FILE] --config "train --preset tiny_test" [--config ...]

For each configuration (the bench's mode, then its other arguments) the bench
runs four times, back to back: from the other checkout (``DIR``, e.g. a
``git archive`` of the parent commit), from this one, from this one again
and from the other: two versions compare only within one call, in turns,
since calls may land on cards with other power limits and neighbours. Each
run is its own process, started from its checkout's root, so each builds
and loads its own kernels. Prints one JSON line a run (``checkout``,
``turn``, ``config``, ``result``: the bench's line, or ``error`` with the
end of its output) and appends it to ``FILE``; exits non-zero if any run
failed.
"""

from __future__ import annotations

import argparse
import json
import shlex
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
ORDER = ("other", "this", "this", "other")


def run_bench(root: Path, config: str) -> dict:
    """One bench process from ``root`` → its JSON line, or the error.
    ``config`` is the mode and the bench's other arguments."""
    mode, *rest = shlex.split(config)
    proc = subprocess.run(
        [sys.executable, "-m", "maskrcnn_tpu_torch.bench", "--mode", mode, *rest],
        cwd=root, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        return {"error": (proc.stdout + proc.stderr)[-2000:],
                "returncode": proc.returncode}
    return json.loads(lines[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, type=Path,
                   help="root of the other checkout")
    p.add_argument("--config", action="append", required=True,
                   help="the bench's mode and arguments, e.g. 'train --preset "
                   "tiny_test'")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    roots = {"other": args.other.resolve(), "this": THIS}
    failed = False
    for config in args.config:
        for turn, name in enumerate(ORDER):
            result = run_bench(roots[name], config)
            failed |= "error" in result
            line = json.dumps({"checkout": name, "turn": turn, "config": config,
                               "result": result})
            print(line, flush=True)
            if args.out:
                with args.out.open("a") as f:
                    f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
