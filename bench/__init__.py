"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic in ``workloads/<cell>.json`` (which
names a driver in ``traffic/``), and each per-layer metric's reader in
``metrics/<metric>.py``.  ``work/`` holds the frozen operation and byte
counts and the card's published peaks, ``reference/`` the plain PyTorch
references that decide ``correct``.  Nothing here imports JAX or the JAX
package.
"""
