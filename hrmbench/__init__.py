"""The benchmark of the PyTorch/CUDA port of HRM (``repro_torch``).

One run serves one cell of ``BENCHMARK.json`` on the card:

    python3 -m hrmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``workloads/<cell>.json`` (whose ``kind`` names
``drivers/<kind>.py``) and ``metrics/<metric>.py``. The plain float32
reference that decides ``correct`` is ``reference/``; it imports nothing of
the port.
"""
