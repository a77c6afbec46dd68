"""drcbench: the benchmark of torchdraco on one GPU. ``python
drcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; everything a cell needs is found by
name under ``configs/``, ``workloads/``, ``entries/`` and ``metrics/``."""
