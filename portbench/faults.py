"""Faults planted under the timed path, which the correctness check has to
catch: the CPU tests run each through a SMOKE run, and ``limits.py
--faults`` reads each at a cell's own size on the card.  Each is a
context manager that patches the program and restores it on exit.
"""
from contextlib import contextmanager


@contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def stale_cache():
    """A step that leaves its state unchanged: the model's cache writes
    are dropped."""
    from repro_torch.models import ops
    return _patched(ops, "_update_cache", lambda cache, new, idx, rows: None)


def alter_token():
    """A token altered where it is produced: each request's third token
    is the next id after the one the logits pick."""
    from repro_torch.serving import engine
    pick = engine.Request.pick

    def wrong(self, row):
        tok = pick(self, row)
        return (tok + 1) % len(row) if len(self.output) == 2 else tok
    return _patched(engine.Request, "pick", wrong)


def zero_transfer():
    """The exchange between instances lost: every transferred cache
    arrives as zeros."""
    from repro_torch.serving import kvtransfer
    extract = kvtransfer.extract

    def zeroed(*a, **kw):
        payload = extract(*a, **kw)
        for layer in payload.tree:
            for t in layer.values():
                t.zero_()
        return payload
    return _patched(kvtransfer, "extract", zeroed)


FAULTS = {"stale_cache": stale_cache, "alter_token": alter_token,
          "zero_transfer": zero_transfer}
