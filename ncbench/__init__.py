"""The benchmark of the PyTorch/CUDA Neural Cache package (``repro_torch``).

``python3 ncbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on one GPU and prints one JSON
line.  Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json`` (with the builder of ``builders/`` and the plain
reference of ``references/`` that it names), ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.
"""
