"""The traced run: ``torch.profiler`` over the steps that follow the
window (the last ``harness.TRACED_SHARE`` of a run's seconds), reduced to
numbers.

The profiler records the device's activity alone (kernels, copies, sets,
and the CUDA runtime calls that launched them), not the host's operators,
whose recording would slow the host further.  The host's side comes from
the harness's own ``portbench::`` spans, stamped by ``time.time_ns``, the
clock of the profiler's timeline.

``read`` returns the traced stretch's length (the ``portbench::window``
span),
the seconds in which the device ran something (the union of its events
inside the window), the device seconds of each kernel name, and the idle
gaps (window time with nothing on the device) summed by what the host was
doing as each began: the innermost harness span, then the CUDA runtime
call open in it, if any.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

WINDOW = "portbench::window"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event the profiler
    recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        dev = e.device_type() == cuda
        if dev and e.is_user_annotation():
            continue        # a host span drawn on the device's timeline
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def short(name: str) -> str:
    """A kernel's name, cut to its function's own name and 64
    characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    return name[:64]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(prof, spans) -> dict:
    """The numbers of a profile and the harness's spans [(name,
    start_ns, end_ns)]."""
    return reduce(_events(prof) + [(n, False, s, e) for n, s, e in spans])


def reduce(evs) -> dict:
    """The numbers of events [(name, is_device, start_ns, end_ns)]."""
    win = [e for e in evs if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError("the trace holds no portbench::window span")
    _, _, w0, w1 = win[0]
    kernel_s: dict[str, float] = defaultdict(float)
    dev = []
    for name, is_dev, s, e in evs:
        if not is_dev or e <= w0 or s >= w1:
            continue
        s, e = max(s, w0), min(e, w1)
        dev.append((s, e))
        kernel_s[name] += (e - s) * 1e-9
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if last < w1:
        gaps.append((last, w1))
    host = sorted((s, e, name) for name, is_dev, s, e in evs
                  if not is_dev and s < w1 and e > w0 and name != WINDOW)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_s,
            "kernel_s": dict(kernel_s),
            "idle_by_host": _label_gaps(gaps, host)}


def _label_gaps(gaps, host) -> dict[str, float]:
    """Gap seconds by the host's activity at each gap's start: a sweep
    over the host events (sorted by start) keeping the stack of those
    still open."""
    starts = [h[0] for h in host]
    out: dict[str, float] = defaultdict(float)
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        j = bisect.bisect_right(starts, g0)
        while i < j:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[1] > g0]
        ours = [h[2] for h in stack if h[2].startswith("portbench::")]
        label = ours[-1] if ours else "portbench::host"
        if stack and not stack[-1][2].startswith("portbench::"):
            label += "/" + stack[-1][2]
        out[label] += (g1 - g0) * 1e-9
    return dict(out)


def top(d: dict, n: int = 10, name=lambda k: k) -> list:
    """The `n` largest entries of {name: seconds}, as [[name, seconds]]."""
    merged: dict[str, float] = defaultdict(float)
    for k, v in d.items():
        merged[name(k)] += v
    return [[k, v] for k, v in sorted(merged.items(),
                                      key=lambda kv: -kv[1])[:n]]
