"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``. Everything that belongs to one
configuration, traffic mix, cell or metric sits in a file of its own under
this folder and is found by the name ``BENCHMARK.json`` gives it.
"""
