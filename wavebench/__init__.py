"""The benchmark of ``jwave_pro_tpu_torch`` on an NVIDIA card.

``python wavebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, one cell or one
per-layer metric is a file of its own, found by its name
(``README.md`` beside this file).
"""
