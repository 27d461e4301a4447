"""The 90th percentile of time to first token over every request whose
first token came in the window: from its send (the end of the step in
which its client's previous request finished) to the end of the call that
produced its first token."""
import numpy as np


def read(run):
    ttft = [r.token_t[0] - r.send_t for r in run.requests
            if r.token_t and run.in_window(r.token_t[0])]
    return float(np.percentile(ttft, 90)) * 1e3 if ttft else None
