"""PD-disaggregated serving runtime on the port's engines (paper Fig. 1 + 8).

The counterpart of the reference package's ``serving/disagg.py``.
Prefiller instances compute prompt KV caches and hand them to decoder
instances through ``kvtransfer`` (the explicit network stage); a Gateway
records arrivals and predicted buckets; the Router runs Alg. 1 (regular
prefillers first, Convertible Decoders for bursts/overflow); the Scaler
periodically evaluates the TokenScale policy against live Observations and
boots/retires instances.  The control plane is the port's copy of the
reference's ``core``.

Instances share a process, a device and the weights.  The virtual clock
advances by the measured wall time of each step, which ends in a device
synchronisation, so the clock counts device work and not its enqueueing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.autoscaler import Observation, Policy
from repro_torch.core.predictor import OutputPredictor
from repro_torch.core.router import BurstDetector, Router
from repro_torch.models import init_state, prefill
from repro_torch.serving import kvtransfer
from repro_torch.serving.engine import Engine, Request, _host, sync
from repro_torch.serving.kvtransfer import TransferStats


class PrefillerInstance:
    """One prefiller: serializes whole-prompt prefills (batch ~1, §II-C1)."""

    def __init__(self, iid: int, cfg: ModelConfig, params, max_len: int):
        self.iid = iid
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.queue: list[Request] = []
        self.tokens_done = 0
        self.wall_s = 1e-9

    # Alg. 1 interface -------------------------------------------------
    def inflight_tokens(self) -> float:
        return float(sum(len(r.prompt) for r in self.queue))

    def prefill_velocity(self) -> float:
        """MEASURED velocity (tokens prefilled per wall second)."""
        if self.tokens_done < 64:        # cold: fall back to a large prior
            return 1e9
        return self.tokens_done / self.wall_s

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def step(self) -> Optional[tuple[Request, kvtransfer.KVPayload, int]]:
        """Prefill one queued request; return (req, payload, first_token)."""
        if not self.queue:
            return None
        req = self.queue.pop(0)
        L = len(req.prompt)
        assert L <= self.max_len, (L, self.max_len)
        pad = min(max(8, 1 << (L - 1).bit_length()), self.max_len)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :L] = req.prompt
        dev = self.params.device
        st = init_state(self.cfg, 1, self.max_len, dev)
        t0 = time.perf_counter()
        logits, st = prefill(self.cfg, self.params, st, toks, [L])
        sync(dev)
        self.wall_s += time.perf_counter() - t0
        self.tokens_done += L
        payload = kvtransfer.extract(self.cfg, st, L, slot=0)
        return req, payload, req.pick(_host(logits[0]))

    @property
    def idle(self) -> bool:
        return not self.queue


class DecoderAdapter:
    """Router-facing view of a decoder Engine (per-bucket load, memory)."""

    def __init__(self, eng: Engine, convertible: bool = False):
        self.eng = eng
        self.is_convertible = convertible
        self.bucket_of_slot: dict[int, str] = {}

    def inflight_of_bucket(self, bucket: str) -> int:
        return sum(1 for s, b in self.bucket_of_slot.items()
                   if b == bucket and self.eng.active[s])

    def mem_util(self) -> float:
        cap = self.eng.num_slots * self.eng.max_len
        return self.eng.memory_tokens_used() / max(cap, 1)

    # convertible decoders also accept raw prefill work (Alg.1 round 2)
    def inflight_tokens(self) -> float:
        pc = self.eng.pending_chunked
        rem = (len(pc.prompt) - pc.prefill_done) if pc else 0
        return float(rem + sum(len(r.prompt) for r in self.eng.waiting))

    def prefill_velocity(self) -> float:
        return float(self.eng.chunk_size) * 20.0 if self.eng.chunk_size \
            else 0.0   # chunk/iteration x ~20 engine iterations/s prior


@dataclass
class GatewayStats:
    arrivals: list = field(default_factory=list)   # (t, in_len, bucket)

    def observe(self, t, in_len, bucket):
        self.arrivals.append((t, in_len, bucket))
        self.arrivals = [a for a in self.arrivals if t - a[0] <= 5.0]

    def rates(self, t, window=1.0):
        win = [a for a in self.arrivals if t - a[0] <= window]
        tok = sum(a[1] for a in win) / window
        by_bucket: dict[str, float] = {}
        for _, n, b in win:
            by_bucket[b] = by_bucket.get(b, 0.0) + n / window
        return tok, by_bucket, len(win) / window


class PDCluster:
    """A miniature PD-disaggregated deployment with live autoscaling."""

    def __init__(self, cfg: ModelConfig, params, policy: Optional[Policy],
                 n_prefillers: int = 1, n_decoders: int = 1,
                 n_convertible: int = 1, slots_per_decoder: int = 4,
                 max_len: int = 128, chunk_size: int = 16,
                 predictor: Optional[OutputPredictor] = None,
                 max_instances: int = 8):
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.max_len = max_len
        self.slots = slots_per_decoder
        self.chunk_size = chunk_size
        self.max_instances = max_instances
        self.router = Router(BurstDetector())
        self.predictor = predictor or OutputPredictor(0.85, 0)
        self.transfers = TransferStats()
        self.gateway = GatewayStats()
        self._iid = 0
        self.prefillers = [self._new_prefiller()
                           for _ in range(n_prefillers)]
        self.decoders = [self._new_decoder() for _ in range(n_decoders)]
        self.convertibles = [self._new_decoder(convertible=True)
                             for _ in range(n_convertible)]
        self.pending: list[tuple[Request, kvtransfer.KVPayload, int]] = []
        self.finished: list[Request] = []
        self.now = 0.0

    def _new_prefiller(self) -> PrefillerInstance:
        self._iid += 1
        return PrefillerInstance(self._iid, self.cfg, self.params,
                                 self.max_len)

    def _new_decoder(self, convertible: bool = False) -> DecoderAdapter:
        self._iid += 1
        eng = Engine(self.cfg, self.params, num_slots=self.slots,
                     max_len=self.max_len,
                     chunk_size=self.chunk_size if convertible else 0)
        return DecoderAdapter(eng, convertible)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.arrival_t = self.now
        bucket = self.predictor.predict_bucket(len(req.prompt),
                                               req.max_new_tokens)
        req.bucket = bucket
        self.router.burst.observe(self.now, float(len(req.prompt)))
        self.gateway.observe(self.now, len(req.prompt), bucket)
        burst = self.convertibles and self.router.burst.is_burst(self.now)
        if burst:
            tgt, kind = self.router.route_prefill(
                len(req.prompt), [], self.convertibles, self.now)
            if tgt is not None:
                tgt.eng.add_request(req)
                if req.slot >= 0:
                    tgt.bucket_of_slot[req.slot] = bucket
                return
        tgt, kind = self.router.route_prefill(
            len(req.prompt), self.prefillers, self.convertibles, self.now)
        if kind == "prefiller":
            tgt.submit(req)
        elif kind == "convertible":
            tgt.eng.add_request(req)
            if req.slot >= 0:
                tgt.bucket_of_slot[req.slot] = bucket
        else:
            min(self.prefillers,
                key=lambda p: p.inflight_tokens()).submit(req)

    # ------------------------------------------------------------------
    def step(self):
        t0 = time.perf_counter()
        # 1. prefillers produce payloads
        for p in self.prefillers:
            out = p.step()
            if out is not None:
                self.pending.append(out)
        # 2. network -> decode admission (per-bucket least-loaded, §IV-E2)
        still = []
        for req, payload, tok in self.pending:
            d = self.router.route_decode(
                getattr(req, "bucket", "M-M"),
                [x for x in self.decoders + self.convertibles
                 if x.eng.free_slots() > 0])
            if d is None:
                still.append((req, payload, tok))
                continue
            ok = d.eng.insert_prefilled(req, payload, tok, self.transfers)
            if ok:
                d.bucket_of_slot[req.slot] = getattr(req, "bucket", "M-M")
            else:
                still.append((req, payload, tok))
        self.pending = still
        # 3. decoders step (requests record their own completion times)
        for d in self.decoders + self.convertibles:
            d.eng.now = self.now
            d.eng.step()
        sync(self.params.device)
        self.now += time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _observation(self) -> Observation:
        tok, by_bucket, rps = self.gateway.rates(self.now)
        utils = [d.mem_util() for d in self.decoders]
        return Observation(
            t=self.now, token_rate_in=tok, token_rate_by_bucket=by_bucket,
            rps=rps,
            prefill_queue=sum(len(p.queue) for p in self.prefillers),
            decode_inflight=sum(int(d.eng.active.sum())
                                for d in self.decoders + self.convertibles),
            mem_util=float(np.mean(utils)) if utils else 0.0,
            cur_prefillers=len(self.prefillers),
            cur_decoders=len(self.decoders))

    def autoscale(self):
        """One Scaler tick: policy -> boot/retire instances (§IV-C)."""
        if self.policy is None:
            return
        dec = self.policy.decide(self._observation())
        while len(self.prefillers) < min(dec.prefillers, self.max_instances):
            self.prefillers.append(self._new_prefiller())
        while len(self.prefillers) > max(dec.prefillers, 1):
            idle = [p for p in self.prefillers if p.idle]
            if not idle:
                break
            self.prefillers.remove(idle[-1])
        while len(self.decoders) < min(dec.decoders, self.max_instances):
            self.decoders.append(self._new_decoder())
        while len(self.decoders) > max(dec.decoders, 1):
            idle = [d for d in self.decoders if d.eng.free_slots()
                    == d.eng.num_slots]
            if not idle:
                break
            self.decoders.remove(idle[-1])

    # ------------------------------------------------------------------
    def run_until_drained(self, max_steps: int = 2000,
                          autoscale_every: int = 10):
        steps = 0
        while self._busy():
            self.step()
            steps += 1
            if steps % autoscale_every == 0:
                self.autoscale()
            if steps > max_steps:
                raise RuntimeError("PD cluster did not drain")

    def _busy(self) -> bool:
        if self.pending:
            return True
        if any(p.queue for p in self.prefillers):
            return True
        for d in self.decoders + self.convertibles:
            if d.eng.active.any() or d.eng.waiting \
                    or d.eng.pending_chunked is not None:
                return True
        return False

    # ------------------------------------------------------------------
    def measured_network_velocity(self, link_bw: float = 50e9) -> float:
        return self.transfers.measured_network_velocity(link_bw)
