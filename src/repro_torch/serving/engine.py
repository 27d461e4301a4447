"""Slot-based continuous-batching inference engine.

The counterpart of the reference package's ``serving/engine.py``.  One
``Engine`` is one prefiller / decoder / convertible-decoder instance in
TokenScale terms: (cfg, params) with a fixed pool of request slots backed
by a preallocated per-slot KV cache on the params' device.

  * ``_prefill_now``  whole-prompt prefill of one request (batch-1 state)
  * ``_step_decode``  one token for every active slot
  * ``_step_mixed``   the Convertible-Decoder step: decode for the active
                      slots, then one restricted prefill chunk of the
                      pending request

The state is updated in place.  So ``_read_slot`` returns a copy: the
mixed step's decode half also writes into the pending slot (a KV row at
its cur_len of 0, or a step of its recurrent state), and the chunk must be
prefilled from the slot as it was.  A request's first chunk starts from a
zeroed state instead: a reused slot still holds its last request's
recurrent state, and every decode step advances the recurrent state of
idle slots too.  (The reference reads the slot at every chunk, so a
recurrent model's chunked request in a reused slot starts from that stale
state there.)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, init_state, prefill


@dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy (the default keeps decoding exact)."""
    temperature: float = 0.0
    top_k: int = 0                     # 0 = no top-k truncation
    top_p: float = 1.0                 # 1.0 = no nucleus truncation
    seed: int = 0


def sample_token(logits: np.ndarray, sp: SamplingParams,
                 rng: np.random.RandomState) -> int:
    """Temperature -> top-k -> top-p -> categorical, on one logits row."""
    if sp.temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits.astype(np.float64) / sp.temperature
    if sp.top_k:
        kth = np.partition(z, -sp.top_k)[-sp.top_k]
        z = np.where(z < kth, -np.inf, z)
    p = np.exp(z - z.max())
    p /= p.sum()
    if sp.top_p < 1.0:
        order = np.argsort(-p)
        csum = np.cumsum(p[order])
        cut = int(np.searchsorted(csum, sp.top_p) + 1)
        mask = np.zeros_like(p)
        mask[order[:cut]] = 1.0
        p = p * mask
        p /= p.sum()
    return int(rng.choice(len(p), p=p))


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (L,) int32
    max_new_tokens: int
    arrival_t: float = 0.0
    sampling: SamplingParams = SamplingParams()
    image_embeds: Optional[np.ndarray] = None   # (num_vision_tokens, d)
    # filled by the engine:
    slot: int = -1
    first_token_t: float = -1.0
    finish_t: float = -1.0
    output: list = field(default_factory=list)
    prefill_done: int = 0              # tokens prefilled so far (chunked)

    def __post_init__(self):
        self._rng = np.random.RandomState(
            (self.sampling.seed * 1009 + self.rid) % (2 ** 31 - 1))

    def pick(self, logits_row: np.ndarray) -> int:
        return sample_token(logits_row, self.sampling, self._rng)


def sync(device: torch.device):
    """Wait for the device's queued work, so a host clock measures it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


def _write_slot(pool, one, slot: int):
    """Copy a batch-1 state into slot `slot` of the pooled state, in place."""
    for pl, ol in zip(pool, one):
        for key, leaf in pl.items():
            leaf[slot].copy_(ol[key][0])
    return pool


def _read_slot(pool, slot: int):
    """A batch-1 COPY of slot `slot` of the pooled state."""
    return [{key: leaf[slot:slot + 1].clone() for key, leaf in pl.items()}
            for pl in pool]


class Engine:
    """A single inference instance with `num_slots` concurrent requests,
    on the device of `params`."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 8,
                 max_len: int = 256, chunk_size: int = 0):
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.chunk_size = chunk_size          # >0 enables convertible mode
        self.state = init_state(cfg, num_slots, max_len, self.device)
        self.cur_lens = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.last_tokens = np.zeros((num_slots,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * num_slots
        self.waiting: list[Request] = []
        self.pending_chunked: Optional[Request] = None
        self.now = 0.0                        # virtual clock (tests/sim)
        # host wall time of decode-only and mixed steps (each ends in a
        # device->host copy of the logits, so it includes the device work)
        self.decode_steps = 0
        self.decode_wall_s = 0.0
        self.mixed_steps = 0
        self.mixed_wall_s = 0.0

    # ------------------------------------------------------------------
    def free_slots(self) -> int:
        return int((~self.active).sum())

    def memory_tokens_used(self) -> int:
        return int(self.cur_lens[self.active].sum())

    def insert_prefilled(self, req: Request, payload, first_token: int,
                         stats=None) -> bool:
        """PD-disaggregation entry point: admit a request whose prefill ran
        on ANOTHER instance; `payload` is the kvtransfer.KVPayload."""
        from repro_torch.serving import kvtransfer
        if self.free_slots() == 0:
            return False
        slot = self._alloc_slot(req)
        t0 = time.perf_counter()
        nbytes = kvtransfer.payload_bytes(payload)
        self.state = kvtransfer.insert(self.cfg, self.state, payload, slot)
        sync(self.device)
        if stats is not None:
            stats.record(nbytes, payload.length, time.perf_counter() - t0)
        self.last_tokens[slot] = first_token
        self.cur_lens[slot] = payload.length
        req.prefill_done = payload.length
        if req.first_token_t < 0:
            req.first_token_t = self.now
        req.output.append(first_token)
        return True

    def add_request(self, req: Request) -> bool:
        """Admit a request; prefill immediately (or queue for chunking)."""
        if self.free_slots() == 0:
            self.waiting.append(req)
            return False
        if self.chunk_size and self.pending_chunked is None \
                and len(req.prompt) > self.chunk_size:
            # convertible decoder: long prompts prefill chunk-by-chunk
            req.slot = self._alloc_slot(req)
            self.pending_chunked = req
            return True
        self._prefill_now(req)
        return True

    def _alloc_slot(self, req: Request) -> int:
        slot = int(np.argmax(~self.active))
        self.active[slot] = True
        self.slot_req[slot] = req
        self.cur_lens[slot] = 0
        return slot

    def _prefill_now(self, req: Request):
        slot = self._alloc_slot(req)
        L = len(req.prompt)
        assert L <= self.max_len, (L, self.max_len)
        pad = min(max(8, int(2 ** np.ceil(np.log2(max(L, 1))))),
                  self.max_len)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :L] = req.prompt
        st1 = init_state(self.cfg, 1, self.max_len, self.device)
        ie = None if req.image_embeds is None else \
            torch.as_tensor(req.image_embeds)[None]
        logits, st1 = prefill(self.cfg, self.params, st1, toks, [L], ie)
        _write_slot(self.state, st1, slot)
        tok = req.pick(_host(logits[0]))
        self.last_tokens[slot] = tok
        self.cur_lens[slot] = L
        req.prefill_done = L
        req.first_token_t = self.now
        req.output.append(tok)

    # ------------------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """One engine iteration.  Returns [(rid, token)] emitted."""
        emitted: list[tuple[int, int]] = []
        if not self.active.any() and self.pending_chunked is None:
            self._drain_waiting()
            return emitted

        if self.pending_chunked is not None:
            emitted += self._step_mixed()
        elif self.active.any():
            emitted += self._step_decode()
        self._drain_waiting()
        return emitted

    def _drain_waiting(self):
        while self.waiting and self.free_slots() > 0:
            self.add_request(self.waiting.pop(0))

    def _step_decode(self) -> list[tuple[int, int]]:
        t0 = time.perf_counter()
        logits, self.state = decode_step(self.cfg, self.params, self.state,
                                         self.last_tokens, self.cur_lens)
        out = self._commit_decode(logits)
        self.decode_steps += 1
        self.decode_wall_s += time.perf_counter() - t0
        return out

    def _step_mixed(self) -> list[tuple[int, int]]:
        req = self.pending_chunked
        C = self.chunk_size
        start = req.prefill_done
        L = len(req.prompt)
        # The chunk is padded to C, but cut at the cache's end: a later
        # chunk's C rows from `start` may run past max_len (the reference
        # pads to C regardless and its cache write clamps onto earlier
        # rows).  The prompt's own tokens fit whenever the prompt fits.
        chunk = np.zeros((1, min(C, self.max_len - start)), np.int32)
        n = min(C, L - start)
        chunk[0, :n] = req.prompt[start:start + n]
        slot = req.slot
        t0 = time.perf_counter()
        st1 = (init_state(self.cfg, 1, self.max_len, self.device)
               if start == 0 else _read_slot(self.state, slot))
        logits, self.state = decode_step(self.cfg, self.params, self.state,
                                         self.last_tokens, self.cur_lens)
        clog, st1 = prefill(self.cfg, self.params, st1, chunk,
                            [min(L, start + n)], start=[start])
        _write_slot(self.state, st1, slot)
        req.prefill_done += n
        out = self._commit_decode(logits, skip_slot=slot)
        clog = _host(clog[0])
        self.mixed_steps += 1
        self.mixed_wall_s += time.perf_counter() - t0
        if req.prefill_done >= L:
            tok = req.pick(clog)
            self.last_tokens[slot] = tok
            self.cur_lens[slot] = L
            req.first_token_t = self.now
            req.output.append(tok)
            self.pending_chunked = None
        return out

    def _commit_decode(self, logits, skip_slot: int = -1):
        emitted = []
        lg = _host(logits)
        for s in range(self.num_slots):
            if not self.active[s] or s == skip_slot:
                continue
            req = self.slot_req[s]
            if req is None or req.prefill_done < len(req.prompt):
                continue
            tok = req.pick(lg[s])
            self.cur_lens[s] += 1
            self.last_tokens[s] = tok
            req.output.append(tok)
            emitted.append((req.rid, tok))
            if len(req.output) >= req.max_new_tokens \
                    or self.cur_lens[s] + 1 >= self.max_len:
                req.finish_t = self.now
                self.active[s] = False
                self.slot_req[s] = None
        return emitted

    # ------------------------------------------------------------------
    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while (self.active.any() or self.waiting
               or self.pending_chunked is not None):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine did not drain")
