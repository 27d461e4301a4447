"""The reference package's four examples on the port, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.burst_absorption
    PYTHONPATH=src python -m repro_torch.examples.pd_disaggregated \\
        [--device cpu] [--engine=events]
    PYTHONPATH=src python -m repro_torch.examples.train_small_model \\
        [--device cpu] [--steps 200]

Each is the reference's script with its imports changed; the profiles and
plans of the full model are for an H100 instance, and the three that run
a real model take ``--device`` ("cuda" by default).
"""
