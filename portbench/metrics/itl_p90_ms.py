"""The 90th percentile of the gaps between consecutive tokens of one
request, over every gap that ended in the window."""
import numpy as np


def read(run):
    gaps = [b - a for r in run.requests
            for a, b in zip(r.token_t, r.token_t[1:]) if run.in_window(b)]
    return float(np.percentile(gaps, 90)) * 1e3 if gaps else None
