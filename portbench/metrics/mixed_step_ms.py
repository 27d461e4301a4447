"""Mean milliseconds of the convertible decoder's mixed steps (decode
plus a chunk) in the window (``Engine.mixed_wall_s / mixed_steps``)."""


def read(run):
    c = run.counters
    if not c.get("mixed_steps"):
        return None
    return c["mixed_wall_s"] / c["mixed_steps"] * 1e3
