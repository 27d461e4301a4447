"""The serving benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  A cell is
``workloads/<cell>.json``: a model configuration (``configs/``), a traffic
mix (``traffic/``) and the entry it drives.  Every metric has a reader of
its own in ``metrics/<name>.py``; the plain references are in
``reference/<family>.py``.  Nothing here imports ``jax`` or the JAX
package, and the references import nothing of the port.
"""
