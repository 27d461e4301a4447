"""The window's seconds over its steps (a step of the PD cluster:
prefill, transfers, decode)."""


def read(run):
    n = len(run.window_steps())
    return run.window_s / n * 1e3 if n else None
