"""Closed-loop traffic: one general generator over the mix files.

A mix (``traffic/<name>.json``) gives lognormal prompt and output lengths
(``in_mean`` / ``in_sigma`` / ``out_mean`` / ``out_sigma``, the fields of
the port's ``sim.traces.TraceSpec``, whose ``_lognormal`` sets
mu = log(mean) - sigma^2 / 2; a mean is the median times
exp(sigma^2 / 2)), their clips, and the size of a block.  A block holds
the lognormal's sizes at its quantiles (i + 1/2) / block, prompts and
outputs each, paired by a permutation fixed by the mix's ``size_seed``.
A run's seed only orders each block anew and draws the prompts' token
ids.  So every seed serves the same sizes in another order, and any
stretch of the stream holds the same work but for one block at each end:
the window's tail does not hinge on which sizes a seed happened to draw.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np

HERE = Path(__file__).resolve().parent


def quantile_sizes(mean, sigma, lo, hi, n):
    """`n` lengths of the lognormal of `mean` and `sigma` (TraceSpec's
    parameters) at its quantiles (i + 1/2) / n, clipped to [lo, hi]."""
    mu = np.log(mean) - sigma ** 2 / 2.0
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.exp(mu + sigma * z), lo, hi).astype(int)


PARAMS = ("loop", "in_mean", "in_sigma", "out_mean", "out_sigma", "in_lo",
          "in_margin", "out_lo", "out_hi", "block", "size_seed")
NOTES = ("name", "source", "users")


def load_mix(name: str, root: Path = HERE) -> dict:
    """A mix's parameters; refuses a file that lacks one of ``PARAMS`` or
    holds a key that the generator does not read (beside the ``NOTES``),
    so that no knob in a mix file goes unheeded."""
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    missing = sorted(set(PARAMS) - set(mix))
    unread = sorted(set(mix) - set(PARAMS) - set(NOTES))
    if missing or unread:
        raise ValueError(f"mix {name}: missing {missing}, not read {unread}")
    return mix


def block_sizes(mix: dict, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The mix's block of (prompt, output) lengths for a cache of
    `max_len` positions: prompts clipped to [in_lo, max_len - in_margin],
    outputs to [out_lo, out_hi]."""
    n = mix["block"]
    ins = quantile_sizes(mix["in_mean"], mix["in_sigma"], mix["in_lo"],
                         max_len - mix["in_margin"], n)
    outs = quantile_sizes(mix["out_mean"], mix["out_sigma"], mix["out_lo"],
                          mix["out_hi"], n)
    return ins, outs[np.random.RandomState(mix["size_seed"]).permutation(n)]


@dataclass(frozen=True)
class Spec:
    """One request of the stream: its index, prompt and output lengths."""
    rid: int
    prompt_len: int
    out_len: int


class Stream:
    """The run's request stream: block after block of the mix's sizes,
    each block in an order drawn from `seed`."""

    def __init__(self, mix: dict, max_len: int, vocab: int, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"mix {mix.get('name')}: only closed loops")
        self.ins, self.outs = block_sizes(mix, max_len)
        self.vocab = vocab
        self.seed = int(seed) % 2 ** 64
        self._order = np.random.default_rng([self.seed, 1])
        self._block: list[int] = []
        self.sent = 0

    def next(self) -> Spec:
        if not self._block:
            self._block = list(self._order.permutation(len(self.ins)))
        i = self._block.pop(0)
        spec = Spec(self.sent, int(self.ins[i]), int(self.outs[i]))
        self.sent += 1
        return spec

    def prompt(self, spec: Spec) -> np.ndarray:
        """The request's token ids, uniform over the vocabulary."""
        rng = np.random.default_rng([self.seed, 2, spec.rid])
        return rng.integers(0, self.vocab, spec.prompt_len, dtype=np.int32)
