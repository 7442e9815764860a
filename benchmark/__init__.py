"""The benchmark of sod100k_tpu_torch, the PyTorch/CUDA port, on NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell is made of is data found by name: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``). The plain reference that decides ``correct``
is ``reference/``; it imports nothing of the port.
"""
