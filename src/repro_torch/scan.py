"""Sequential scans, the port's ``lax.scan``, and how a dry-run counts them.

``scan(step, carry, xs, n, width)`` runs ``step`` n times in a Python
loop: step i takes the carry and the i-th slice of `width` positions of
each sequence in `xs` (along dim 1) and returns the next carry and its
output, and the outputs are concatenated along dim 1.  The recurrent
layers' plain versions use it (Mamba's selective scan, ``models.ops``;
the chunked WKV6, ``kernels.ref``).

A dry-run counts a step on ``meta`` tensors, where every step of a scan
has the same shapes.  Under ``folding()`` a scan of meta tensors runs its
first step once, inside ``repeats(n)``, which tells the counter
(``launch.roofline.count_step``) to count each op n times: the
reference's HLO count of a ``while`` body times its trip count.  Its
backward is the first step's, counted n times, with the eager engine's
own work for the slices (each step's gradient of a sequence written into
a zeroed whole-size tensor, and those summed) and for the per-step
gradients of the constants (summed); and while a graph is kept for the
backward, the bytes that n steps would save for it are held too.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_tls = threading.local()


def multiplier() -> int:
    """How many times the counter counts the op it sees (1 outside any
    ``repeats``)."""
    return getattr(_tls, "mult", 1)


@contextlib.contextmanager
def repeats(n: int):
    """Count every op inside n times over (nested: the product)."""
    before = multiplier()
    _tls.mult = before * n
    try:
        yield
    finally:
        _tls.mult = before


@contextlib.contextmanager
def folding():
    """Scans of meta tensors run one step, counted n times."""
    before = getattr(_tls, "fold", False)
    _tls.fold = True
    try:
        yield
    finally:
        _tls.fold = before


def _steps(step, carry, xs, width, consts):
    return step(carry, [x.narrow(1, 0, width) for x in xs], *consts)


class _Folded(torch.autograd.Function):
    """The scan of n steps as its first step counted n times (module
    docstring); returns (the carry after it, the n outputs' shapes)."""

    @staticmethod
    def forward(ctx, step, n, width, n_xs, grad, carry, *rest):
        xs, consts = rest[:n_xs], rest[n_xs:]
        ctx.step, ctx.n, ctx.width, ctx.n_xs = step, n, width, n_xs
        # saved with the inputs, so that activation checkpointing drops it
        # as it drops what the steps would save
        held = [_held(step, carry, xs, width, consts, n)] \
            if grad and any(ctx.needs_input_grad[5:]) else []
        ctx.save_for_backward(carry, *rest, *held)
        with repeats(n):
            c1, y = _steps(step, carry, xs, width, consts)
        return c1, torch.cat([y] * n, 1)

    @staticmethod
    def backward(ctx, g_carry, g_ys):
        n, width, n_xs = ctx.n, ctx.width, ctx.n_xs
        carry, *rest = ctx.saved_tensors[:len(ctx.needs_input_grad) - 5]
        xs, consts = rest[:n_xs], rest[n_xs:]
        # every step but the first takes a carry that needs a gradient,
        # and gives one that gets a gradient: so does the counted step
        need = list(ctx.needs_input_grad[5:])
        ins = [t.detach().requires_grad_(k or (i == 0
                                               and t.is_floating_point()))
               for i, (t, k) in enumerate(zip([carry, *xs, *consts], need))]
        with repeats(0), torch.enable_grad():
            c_in, *parts = ins
            slices = [x.narrow(1, 0, width) for x in parts[:n_xs]]
            c1, y = ctx.step(c_in, slices, *parts[n_xs:])
        wrt = [t for t in [c_in, *slices, *parts[n_xs:]] if t.requires_grad]
        g_carry = torch.zeros_like(c1) if g_carry is None else g_carry
        outs = [(o, g) for o, g in ((c1, g_carry),
                                    (y, g_ys.narrow(1, 0, width)))
                if o.requires_grad]
        with repeats(n):
            got = iter(torch.autograd.grad([o for o, _ in outs],
                                           wrt, [g for _, g in outs],
                                           allow_unused=True,
                                           materialize_grads=True))
            g_c = next(got) if c_in.requires_grad else None
            g_c = g_c if need[0] else None
            g_x = []
            for x, s in zip(parts[:n_xs], slices):
                if not s.requires_grad:
                    g_x.append(None)
                    continue
                whole = torch.zeros_like(x)
                whole.narrow(1, 0, width).copy_(next(got))
                g_x.append(whole)
            g_k = [next(got) if t.requires_grad else None
                   for t in parts[n_xs:]]
        with repeats(n - 1):         # the engine sums the n steps' parts
            g_x = [g if g is None else g + g for g in g_x]
            g_k = [g if g is None else g + g for g in g_k]
        return (None, None, None, None, None, g_c, *g_x, *g_k)


def _held(step, carry, xs, width, consts, n):
    """A meta tensor of the bytes that n steps save for the backward: one
    step's saved tensors, but for its inputs, measured uncounted."""
    inputs = {id(t.untyped_storage()) for t in (carry, *xs, *consts)}
    seen: dict = {}

    def pack(t):
        st = t.untyped_storage()
        if id(st) not in inputs:
            seen[id(st)] = st.nbytes()
        return t

    with repeats(0), torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ins = [t.detach().requires_grad_(t.is_floating_point())
               for t in (carry, *xs, *consts)]
        _steps(step, ins[0], ins[1:1 + len(xs)], width, ins[1 + len(xs):])
    return torch.empty(n * sum(seen.values()), dtype=torch.uint8,
                       device=carry.device)


def scan(step, carry: torch.Tensor, xs, n: int, width: int = 1,
         consts=()):
    """carry, ys: for i in range(n), carry, y_i = step(carry, [x[:, i w :
    (i + 1) w] for x in xs], *consts); ys = the y_i concatenated along dim
    1.  Under ``folding()`` with meta tensors, one step counted n times."""
    if getattr(_tls, "fold", False) and carry.device.type == "meta" and n:
        return _Folded.apply(step, n, width, len(xs), torch.is_grad_enabled(),
                             carry, *xs, *consts)
    ys = []
    for i in range(n):
        carry, y = step(carry, [x[:, i * width:(i + 1) * width] for x in xs],
                        *consts)
        ys.append(y)
    return carry, torch.cat(ys, 1)
