"""The benchmark of the PyTorch/CUDA port ``maskrcnn_tpu_torch``.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the GPUs of
this machine and prints one JSON line. Everything a cell is made of sits in
files of its own, found by name: ``configs/<config>.json`` (the model
configuration as it is run), ``workloads/<cell>.json`` (its traffic and
parameters), ``traffic/<kind>.py`` (the generator and window of a traffic
kind) and ``metrics/<metric>.py`` (one per-layer metric's reader). The
plain reference that decides ``correct`` is ``reference/``; it imports
nothing of the program.
"""
