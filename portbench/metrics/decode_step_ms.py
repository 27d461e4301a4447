"""Mean milliseconds of the decoder's decode-only steps in the window
(``Engine.decode_wall_s / decode_steps``)."""


def read(run):
    c = run.counters
    if not c.get("decode_steps"):
        return None
    return c["decode_wall_s"] / c["decode_steps"] * 1e3
