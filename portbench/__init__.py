"""The benchmark of the PyTorch and CUDA port (``pde_opt_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card(s) and
prints one JSON line.  See ``portbench/README.md``.
"""
