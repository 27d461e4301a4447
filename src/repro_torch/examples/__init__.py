"""The reference package's three examples on the port, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.burst_absorption
    PYTHONPATH=src python -m repro_torch.examples.pd_disaggregated \\
        [--device cpu] [--engine=events]

Each is the reference's script with its imports changed; the profiles and
plans of the full model are for an H100 instance, and the two that run a
real engine take ``--device`` ("cuda" by default).
"""
