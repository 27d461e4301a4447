"""The share of the window's steps that ran a prefill or a chunk."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    hit = sum(1 for s in steps if any(c["kind"] == "prefill"
                                      for c in s.calls))
    return 100.0 * hit / len(steps)
