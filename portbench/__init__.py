"""The benchmark of the PyTorch and CUDA port (``mri_super_resolution_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Configurations, traffic mixes, cells, entries and metrics
are files of their own here, found by their names."""
