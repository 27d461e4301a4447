"""The prefiller's prompt tokens over its prefill seconds in the window
(``PrefillerInstance.tokens_done`` / ``wall_s``; its clock stops after a
device sync)."""


def read(run):
    c = run.counters
    if not c.get("prefill_wall_s"):
        return None
    return c["prefill_tokens"] / c["prefill_wall_s"]
