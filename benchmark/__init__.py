"""The benchmark of ``auncel_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything that belongs to one
configuration, traffic mix, layer or per-layer metric sits in a file of its
own (``configs/``, ``traffic/``, ``layers/``, ``metrics/``), found by the
name that ``BENCHMARK.json`` gives it. ``reference/`` is the plain
reference that decides ``correct``; it imports nothing of the program.
"""
