"""The benchmark of ``lshrs_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: ``configs/<config>.json``
(a deployment: data scale, widths, the index's constructor), a traffic
mix ``traffic/<traffic>.json`` (parameters, and which of
``clients/<kind>.py`` runs them), ``checks/<cell>.json`` (the limit of
the comparison that decides ``correct``) and one reader
``metrics/<metric>.py`` per metric (or one per metric family:
``idle_pct.batch`` falls back to ``metrics/idle_pct.py``).

Nothing here imports JAX, ``lshrs_tpu`` or the repository's older bench
scripts; ``reference/`` imports nothing of ``lshrs_tpu_torch`` either.
"""
