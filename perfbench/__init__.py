"""The benchmark of ``deephumor_tpu_torch`` on NVIDIA GPUs.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations (``configs/``), traffic mixes (``traffic/``)
and per-layer metrics (``metrics/``) are files found by the names that
``BENCHMARK.json`` gives them; ``reference/`` holds the plain PyTorch
reference that decides whether a run is correct. Nothing here imports
JAX or the JAX package.
"""
