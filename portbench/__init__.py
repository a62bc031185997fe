"""The port's benchmark: MaRe actions on one NVIDIA GPU, driven by data.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  ``portbench/README.md`` describes the layout and how to add a
configuration, a cell or a metric without editing a file that is there.
"""
