"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names (``maskrcnn_tpu_torch`` is not ``maskrcnn_tpu``):
from ``benchmark.run`` through a rehearsal of a cell, traced, in a fresh
interpreter. And the reference imports nothing of the program."""

import os
import subprocess
import sys

from benchmark import run as bench_run
from benchmark import spec

SCRIPT = """
import json
from benchmark.tests.rehearsal import rehearse
from benchmark.run import forbidden_modules
import sys
line = rehearse("fpn_mask-serve", trace=1)
print(json.dumps({"forbidden": forbidden_modules(), "correct": line["correct"],
                  "program": "maskrcnn_tpu_torch" in sys.modules}))
"""


def test_rehearsal_loads_no_jax():
    env = {**os.environ, "PYTHONPATH": str(spec.ROOT)}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = out.stdout.strip().splitlines()[-1]
    assert '"forbidden": []' in result and '"program": true' in result
    assert '"correct": true' in result


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "maskrcnn_tpu_torch.lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert not set(bench_run.forbidden_modules()) & {"maskrcnn_tpu", "jax"}
    monkeypatch.setitem(sys.modules, "jax.lookalike", sys)
    monkeypatch.setitem(sys.modules, "maskrcnn_tpu", sys)
    assert {"jax", "maskrcnn_tpu"} <= set(bench_run.forbidden_modules())


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "import maskrcnn_tpu" not in text and "from maskrcnn_tpu" not in text, path
