"""Prompt tokens over the tokens the window's prefill calls computed
(whole prompts padded to a power of two, chunks to the chunk)."""


def read(run):
    calls = run.window_calls("prefill")
    padded = sum(c["padded"] for c in calls)
    return 100.0 * sum(c["n"] for c in calls) / padded if padded else None
