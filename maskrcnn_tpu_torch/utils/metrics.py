"""Structured metric logging — JSONL with the reference's scalar names.

Spec: the reference reports 6 scalars per step via chainer's reporter
(reference chainer_maskrcnn/model/fpn_maskrcnn_train_chain.py:108-115) into
LogReport (a JSON log in the out dir) + PrintReport columns
(train.py:142-161). Same scalar names here (``main/loss`` etc.) so logs are
directly comparable; plus wall-clock and images/sec, which the reference
lacked (SURVEY §6).
"""

from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, out_dir: str, print_every: int = 100,
                 file_name: str = "log.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, file_name)
        self._f = open(self.path, "a", buffering=1)
        self.print_every = print_every
        self._t_start = time.time()
        self._t_last = self._t_start
        self._imgs_since = 0
        self._header_printed = False

    def log(self, step: int, scalars: dict, n_images: int = 0, lr: float | None = None):
        self._imgs_since += n_images
        record = {"iteration": step, "elapsed_time": time.time() - self._t_start}
        # chainer-compatible names: main/<name>
        for k, v in scalars.items():
            record[f"main/{k}"] = float(v)
        if lr is not None:
            record["lr"] = float(lr)
        self._f.write(json.dumps(record) + "\n")

        if step % self.print_every == 0:
            now = time.time()
            ips = self._imgs_since / max(now - self._t_last, 1e-9)
            self._t_last = now
            self._imgs_since = 0
            cols = ["iteration", "lr", *[f"main/{k}" for k in scalars]]
            if not self._header_printed:
                print("  ".join(f"{c:>16s}" for c in [*cols, "img/s"]))
                self._header_printed = True
            vals = [f"{step:>16d}", f"{(lr or 0):>16.6f}"]
            vals += [f"{float(v):>16.4f}" for v in scalars.values()]
            vals += [f"{ips:>16.2f}"]
            print("  ".join(vals))
            sys.stdout.flush()

    def log_validation(self, step: int, report: dict):
        """Write an in-training evaluation as a ``validation/main/*`` row —
        the reference's LogReport records its evaluator extension under the
        same prefix (reference train.py:142-166, evaluator.py:92-104).
        Round-4 lesson: a 0.0-AP flagship run went unnoticed for 6000 steps
        because eval results were only ever printed."""
        record = {"iteration": step,
                  "elapsed_time": time.time() - self._t_start}
        for k, v in report.items():
            if isinstance(v, (int, float)):
                record[f"validation/main/{k}"] = float(v)
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        self._f.close()
