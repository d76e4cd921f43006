"""The benchmark of the PyTorch and CUDA port (``alg_tpu_torch``).

One command runs one cell once (``python3 -m benchmark.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``). Everything a cell needs is found by
name: the cell in ``BENCHMARK.json``, its configuration under ``configs/``, its
traffic under ``traffic/``, the traffic's driver under ``drivers/``, its
correctness limits under ``limits/`` and each per-layer metric's reader under
``metrics/``. ``reference/`` is the plain PyTorch reference that decides
``correct``; it imports nothing of the port.
"""
