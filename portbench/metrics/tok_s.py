"""Tokens a second: the prompt tokens of every request whose first token
came in the window, plus every output token stamped in the window,
over the window's seconds."""


def read(run):
    if run.window_s <= 0:
        return None
    prompt = sum(r.prompt_len for r in run.requests
                 if r.token_t and run.in_window(r.token_t[0]))
    out = sum(1 for r in run.requests for t in r.token_t if run.in_window(t))
    return (prompt + out) / run.window_s
