"""Tiered KV-cache subsystem: paged blocks, host-DRAM offload, prefix reuse.

The sim's original memory model was a single flat HBM byte counter per
decoder (``Decoder.mem_used``/``mem_cap``), so preemption charged a
synthetic swap delay with no memory hierarchy behind it and conversational
traces got zero benefit from shared prefixes.  This module is the memory
hierarchy (DESIGN.md "KV-tier fidelity"):

  * **Paged block allocator** — KV lives in fixed-size blocks of
    ``block_size`` tokens (vLLM-style paging); a request reserves
    ``ceil(((in_len + out_len) * kv_tok + state_fix) / block_bytes)``
    blocks at admission (conservative full-length reservation, so decode
    never OOMs mid-iteration — the same invariant the legacy byte counter
    checked at admission).
  * **Two-tier store** — an HBM tier (blocks carved out of the decoder's
    usable HBM after weights/reserve) and a host-DRAM offload tier
    (capacity and swap bandwidth per chip, ``core.hardware.ChipSpec
    .host_dram_cap``/``swap_bw``).  Pause-requeue preemption becomes a
    real swap: the victim's owned blocks move to the DRAM tier (swap-out
    overlapped, HBM freed immediately) and the swap-in stall is charged at
    the swap bandwidth; when the tier is full the victim falls back to a
    full recompute, exactly like evict-lowest.
  * **Prefix tree with copy-on-write reuse** — finished requests leave
    their prompt+output blocks cached under their session id (ref-counted;
    reclaimed LRU under pressure, demoted to the DRAM tier when it has
    room).  A same-session follow-up whose prompt extends the cached
    prefix shares those blocks copy-on-write: shared blocks are read-only
    and only ever *referenced* (never written — entries round down to full
    blocks, so the partially-filled tail block is always freshly
    allocated), and the prefiller only computes the uncached suffix.
    Sessions are chains (each follow-up extends one prefix), so the radix
    tree degenerates to one longest-prefix entry per session — the entry
    *is* the radix path.

Bookkeeping is double-entry: every block is either on the free list or in
``ref`` (total references: allocations + pins + cache entries), and a
separate ``hard`` count (allocations + pins only) drives the memory-
pressure signal — cached-but-reclaimable blocks do not count against
admission.  ``check()`` re-derives both from first principles; the
property tests in ``tests/test_kvcache.py`` call it after every operation
and at the end of end-to-end runs on both engines.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Optional


class KVError(RuntimeError):
    """Allocator invariant violation (double admit/free, over-allocation)."""


# ---------------------------------------------------------------------------
# Cluster-wide counters (shared by every decoder's allocator + the engines)
# ---------------------------------------------------------------------------

@dataclass
class KVStats:
    """Aggregated across all decoders of a cluster; ``SimReport.kv``."""
    lookups: int = 0
    hits: int = 0                 # arrivals that reused a cached prefix
    hit_tokens: int = 0           # prompt tokens served from cache
    prompt_tokens: int = 0        # all prompt tokens seen by lookups
    offload_bytes: float = 0.0    # bytes written to the host-DRAM tier
    demotions: int = 0            # prefix entries demoted HBM -> DRAM
    swap_outs: int = 0            # victims swapped to the DRAM tier
    swap_ins: int = 0             # swapped victims restored to HBM
    swap_fallbacks: int = 0       # pause-requeue fell back to recompute
    swap_stall_s: float = 0.0     # stalls charged at swap/interconnect bw
    prefix_migrations: int = 0    # hits admitted away from the owner
    prefix_recomputes: int = 0    # pinned prefix lost before admission
    total_blocks: int = 0         # HBM blocks across all live allocators
    cur_used: int = 0             # hard-used blocks right now (all tiers' HBM)
    peak_used: int = 0            # watermark of cur_used
    peak_frac: float = 0.0        # watermark of any one decoder's used/total

    def on_used_delta(self, delta: int, frac: float):
        self.cur_used += delta
        self.peak_used = max(self.peak_used, self.cur_used)
        self.peak_frac = max(self.peak_frac, frac)

    def summary(self) -> dict:
        return {
            "prefix_hit_rate": self.hit_tokens / max(self.prompt_tokens, 1),
            "prefix_hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "offload_bytes": self.offload_bytes,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swap_fallbacks": self.swap_fallbacks,
            "swap_stall_s": self.swap_stall_s,
            "peak_blocks": self.peak_used,
            "peak_blocks_frac": self.peak_frac,
        }


# ---------------------------------------------------------------------------
# Per-decoder allocator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KVTierConfig:
    """Resolved tier geometry for one decoder."""
    block_size: int               # tokens per block
    block_bytes: float            # block_size * kv_bytes_per_token
    n_hbm: int                    # HBM blocks (usable HBM / block_bytes)
    n_dram: int                   # host-DRAM tier blocks (0 = no tier)
    swap_bw: float                # HBM <-> host bytes/s
    prefix_cache: bool = False


@dataclass
class _Allocation:
    """One resident request's blocks: CoW-shared prefix + owned rest."""
    shared: list[int] = field(default_factory=list)
    owned: list[int] = field(default_factory=list)
    shared_tokens: int = 0


@dataclass
class _CacheEntry:
    """Longest cached prefix of one session (the radix path)."""
    ids: tuple[int, ...]          # HBM blocks; empty once demoted to DRAM
    tokens: int                   # full-block tokens covered
    last_use: float
    tier: str = "hbm"             # "hbm" | "dram"
    dram_blocks: int = 0          # DRAM blocks held once demoted
    pins: int = 0                 # in-flight arrivals relying on this entry


@dataclass
class _Pin:
    entry: _CacheEntry
    ids: tuple[int, ...]          # () for DRAM-tier pins
    tokens: int
    tier: str


class KVAllocator:
    """Paged two-tier KV store for one decoder (see module docstring)."""

    def __init__(self, cfg: KVTierConfig, stats: Optional[KVStats] = None):
        if cfg.block_size <= 0 or cfg.n_hbm <= 0:
            raise KVError(f"degenerate tier geometry: {cfg}")
        self.cfg = cfg
        self.stats = stats or KVStats()
        self.stats.total_blocks += cfg.n_hbm
        self.free: list[int] = list(range(cfg.n_hbm - 1, -1, -1))
        self.ref: dict[int, int] = {}          # block -> total references
        self.hard: dict[int, int] = {}         # block -> alloc+pin references
        self.hard_used = 0                     # len({b: hard[b] > 0})
        self.allocs: dict[int, _Allocation] = {}      # rid -> allocation
        # key -> prefix entry; keys are session ids (ints) or gateway
        # shared-prompt aliases (("sys", prompt_id) tuples) — any hashable
        self.sessions: dict = {}
        self.pins: dict[int, _Pin] = {}               # rid -> arrival pin
        # entries dropped (replaced by a longer prefix) while arrival pins
        # still referenced them: kept here until the pins drain so
        # ``check()`` can prove no pin ever dangles (the pin-leak audit)
        self._retired: list[_CacheEntry] = []
        self.dram_free = cfg.n_dram
        self.tickets: dict[int, int] = {}      # rid -> swapped-out blocks
        # ---- admission-path cache (DESIGN.md "Performance") ----
        # ``available()`` walks every cache entry's blocks; on the hot
        # admission path it is probed once per (pending request, candidate
        # decoder) pair.  The allocator state version bumps on any ref/pin
        # /session mutation and keys a memo of the identical recompute.
        self._ver = 0
        self._avail_ver = -1
        self._avail_val = 0

    def _mutated(self):
        self._ver += 1

    # ---- geometry ----------------------------------------------------
    def blocks_for(self, nbytes: float) -> int:
        return max(int(-(-nbytes // self.cfg.block_bytes)), 1)

    def token_bytes(self, tokens: int) -> float:
        """KV bytes behind ``tokens`` cached tokens (block_bytes is
        block_size * kv_bytes_per_token, so this is tokens * kv_tok)."""
        return tokens * self.cfg.block_bytes / self.cfg.block_size

    def migration_stall(self, tokens: int, net_bw: float) -> float:
        """Charge shipping a cached prefix over the owner's interconnect
        to wherever the request was actually admitted; returns the stall.
        One definition for both charge sites (admission-time on-box
        migration and the cluster's penalty-requeue path)."""
        delay = self.token_bytes(tokens) / max(net_bw, 1e-9)
        self.stats.prefix_migrations += 1
        self.stats.swap_stall_s += delay
        return delay

    def need_blocks(self, rid: int, nbytes: float) -> int:
        """Blocks a fresh admission must allocate, net of the arrival pin's
        CoW-shared prefix blocks (if the pin lives on this decoder)."""
        pin = self.pins.get(rid)
        shared = len(pin.ids) if pin and pin.tier == "hbm" else 0
        return max(self.blocks_for(nbytes) - shared, 0)

    def available(self) -> int:
        """Free blocks plus blocks reclaimable from unpinned cache
        entries (cached prefixes never block an admission).  Memoized on
        the allocator state version — the recompute is the identical
        reduction, so the value is bitwise what the seed code returned."""
        if self._avail_ver != self._ver:
            reclaimable = sum(
                1 for e in self.sessions.values()
                if e.tier == "hbm" and e.pins == 0
                for b in e.ids if self.ref[b] == 1)
            self._avail_val = len(self.free) + reclaimable
            self._avail_ver = self._ver
        return self._avail_val

    def can_admit(self, rid: int, nbytes: float) -> bool:
        return self.need_blocks(rid, nbytes) <= self.available()

    def used_bytes(self) -> float:
        """Hard-used bytes (allocations + pins; cached-reclaimable blocks
        excluded) — the decoder's memory-pressure signal."""
        return self.hard_used * self.cfg.block_bytes

    @property
    def busy(self) -> bool:
        """In-flight arrivals rely on this decoder's cached prefixes; it
        must not be scaled down underneath them."""
        return bool(self.pins) or bool(self.allocs)

    # ---- internal ref bookkeeping ------------------------------------
    def _incref(self, b: int):
        self._mutated()
        self.ref[b] = self.ref.get(b, 0) + 1

    def _decref(self, b: int):
        self._mutated()
        n = self.ref.get(b, 0)
        if n <= 0:
            raise KVError(f"double free of block {b}")
        if n == 1:
            del self.ref[b]
            self.free.append(b)
        else:
            self.ref[b] = n - 1

    def _hard_inc(self, b: int):
        n = self.hard.get(b, 0)
        self.hard[b] = n + 1
        if n == 0:
            self.hard_used += 1
            self.stats.on_used_delta(+1, self.hard_used / self.cfg.n_hbm)

    def _hard_dec(self, b: int):
        n = self.hard.get(b, 0)
        if n <= 0:
            raise KVError(f"hard-ref underflow on block {b}")
        if n == 1:
            del self.hard[b]
            self.hard_used -= 1
            self.stats.on_used_delta(-1, self.hard_used / self.cfg.n_hbm)
        else:
            self.hard[b] = n - 1

    def _alloc(self, n: int) -> list[int]:
        while len(self.free) < n:
            if not self._reclaim_one():
                raise KVError(
                    f"out of HBM blocks: need {n}, free {len(self.free)}")
        out = []
        for _ in range(n):
            b = self.free.pop()
            self._incref(b)
            self._hard_inc(b)
            out.append(b)
        return out

    def _drop_entry(self, key):
        self._mutated()
        e = self.sessions.pop(key)
        if e.tier == "hbm":
            for b in e.ids:
                self._decref(b)
        else:
            self.dram_free += e.dram_blocks
        # the entry's own storage is gone either way (HBM refs released,
        # DRAM blocks freed — byte-identical to the historical drop); if
        # arrival pins still reference it, park it on the retired list so
        # the no-stale-pins invariant can account for them until unpin
        e.ids, e.dram_blocks, e.tier = (), 0, "retired"
        if e.pins > 0:
            self._retired.append(e)

    def _reclaim_one(self) -> bool:
        """Reclaim the LRU unpinned HBM cache entry; demote it to the DRAM
        tier when the tier has room, drop it otherwise.  Returns False when
        nothing is reclaimable."""
        cands = [(sid, e) for sid, e in self.sessions.items()
                 if e.tier == "hbm" and e.pins == 0]
        if not cands:
            return False
        # keys mix legacy int session ids with ("sys", pid) tuples; the
        # type flag partitions them so the tie-break never compares across
        # types (ints first, preserving the historical int ordering)
        sid, e = min(cands, key=lambda kv: (
            kv[1].last_use, isinstance(kv[0], tuple),
            kv[0] if isinstance(kv[0], tuple) else (kv[0],)))
        n = len(e.ids)
        if self.dram_free >= n > 0:
            self.dram_free -= n
            self.stats.demotions += 1
            self.stats.offload_bytes += n * self.cfg.block_bytes
            for b in e.ids:
                self._decref(b)
            e.ids, e.tier, e.dram_blocks = (), "dram", n
        else:
            self._drop_entry(sid)
        return True

    # ---- prefix tree -------------------------------------------------
    def lookup(self, key, prefix_len: int) -> tuple[int, str]:
        """Reusable full-block prefix tokens under ``key`` — a session id
        (int) or a gateway shared-prompt alias (tuple) — and the tier they
        live in.  (0, "") on miss."""
        if not self.cfg.prefix_cache or key is None \
                or (isinstance(key, int) and key < 0):
            return 0, ""
        e = self.sessions.get(key)
        if e is None:
            return 0, ""
        bs = self.cfg.block_size
        usable = (min(e.tokens, prefix_len) // bs) * bs
        return (usable, e.tier) if usable > 0 else (0, "")

    def pin(self, rid: int, key, tokens: int, t: float):
        """Reserve a looked-up prefix for ``rid`` until it is admitted (or
        the hit is abandoned): HBM pins take a reference on each shared
        block, DRAM pins just hold the entry against eviction.  ``key`` is
        a session id or a gateway shared-prompt alias."""
        if rid in self.pins:
            raise KVError(f"request {rid} already holds a pin")
        self._mutated()
        e = self.sessions[key]
        e.last_use = t
        e.pins += 1
        if e.tier == "hbm":
            ids = e.ids[:tokens // self.cfg.block_size]
            for b in ids:
                self._incref(b)
                self._hard_inc(b)
            self.pins[rid] = _Pin(e, ids, tokens, "hbm")
        else:
            self.pins[rid] = _Pin(e, (), tokens, "dram")

    def unpin(self, rid: int):
        pin = self.pins.pop(rid, None)
        if pin is None:
            return
        self._mutated()
        self._entry_unpin(pin.entry)
        for b in pin.ids:
            self._hard_dec(b)
            self._decref(b)

    def _entry_unpin(self, e: _CacheEntry):
        e.pins -= 1
        if e.pins == 0 and e.tier == "retired":
            # identity removal: _CacheEntry is a value-comparing dataclass
            # and two drained retired entries can be field-equal
            for i, x in enumerate(self._retired):
                if x is e:
                    del self._retired[i]
                    break

    # ---- admission / release -----------------------------------------
    def admit(self, rid: int, nbytes: float):
        """Allocate ``rid``'s full-length reservation, consuming its pin's
        CoW-shared blocks if the pin lives here.  Callers must have checked
        ``can_admit``; failure raises (a control-plane bug, not
        backpressure)."""
        if rid in self.allocs:
            raise KVError(f"request {rid} admitted twice")
        self._mutated()
        pin = self.pins.pop(rid, None)
        shared: list[int] = []
        shared_tokens = 0
        if pin is not None:
            self._entry_unpin(pin.entry)
            if pin.tier == "hbm":
                # the pin's block+hard references transfer to the allocation
                shared, shared_tokens = list(pin.ids), pin.tokens
            # a DRAM-tier pin must be resolved (penalized) by the cluster
            # before admission; tolerate it here as a plain miss
        n_new = max(self.blocks_for(nbytes) - len(shared), 0)
        owned = self._alloc(n_new)
        self.allocs[rid] = _Allocation(shared, owned, shared_tokens)

    def try_grow(self, rid: int, nbytes: float) -> Optional[int]:
        """Allocate-on-generate paging: extend ``rid``'s allocation so it
        covers ``nbytes`` total.  Returns the number of blocks added (0 if
        already covered), or None when the decoder is out of blocks even
        after reclaiming unpinned cache entries — the mid-decode OOM the
        cluster resolves by preempting (never raises: exhaustion is
        backpressure here, not a control-plane bug)."""
        a = self.allocs.get(rid)
        if a is None:
            raise KVError(f"grow of unknown request {rid}")
        need = self.blocks_for(nbytes) - len(a.shared) - len(a.owned)
        if need <= 0:
            return 0
        if self.available() < need:
            return None
        a.owned.extend(self._alloc(need))
        return need

    def cache_alias(self, key, rid: int, tokens: int, t: float) -> int:
        """Cache the first ``tokens`` (rounded down to full blocks) of
        ``rid``'s *live* allocation under an additional key — the gateway's
        shared-prompt alias, taken just before ``release`` so cross-session
        arrivals can reuse the hot system prompt.  Entry references only
        (reclaimable, no admission pressure).  A shorter or pin-free
        existing alias is replaced; a pinned one is left alone (in-flight
        arrivals rely on it).  Returns the tokens cached (0 if skipped)."""
        if not self.cfg.prefix_cache or tokens <= 0:
            return 0
        a = self.allocs.get(rid)
        if a is None:
            raise KVError(f"alias of unknown request {rid}")
        bs = self.cfg.block_size
        blocks = a.shared + a.owned
        keep = min(tokens // bs, len(blocks))
        if keep <= 0:
            return 0
        old = self.sessions.get(key)
        if old is not None:
            if old.pins > 0 or old.tokens >= keep * bs:
                old.last_use = t
                return 0
            self._drop_entry(key)
        ids = blocks[:keep]
        for b in ids:
            self._incref(b)
        self.sessions[key] = _CacheEntry(tuple(ids), keep * bs, t)
        return keep * bs

    def install(self, key, tokens: int, t: float) -> bool:
        """Hot-prefix replication landing: materialize a ``tokens``-long
        cache entry under ``key`` (the copy shipped over the interconnect
        from the prefix's origin decoder).  Cache-only blocks — entry
        references, never hard — so a replica competes with other cached
        prefixes for space but never reduces admission headroom.  Returns
        False (a no-op) when the blocks can't be found even after
        reclaiming, or when a pinned/longer entry already holds the key."""
        if not self.cfg.prefix_cache:
            return False
        bs = self.cfg.block_size
        n = tokens // bs
        if n <= 0:
            return False
        old = self.sessions.get(key)
        if old is not None:
            if old.pins > 0 or old.tokens >= n * bs:
                old.last_use = t
                return False
            self._drop_entry(key)
        while len(self.free) < n:
            if not self._reclaim_one():
                return False
        ids = []
        for _ in range(n):
            b = self.free.pop()
            self._incref(b)
            ids.append(b)
        self.sessions[key] = _CacheEntry(tuple(ids), n * bs, t)
        return True

    def release(self, rid: int, sid: int, ctx_tokens: int, t: float):
        """Finish: free the reservation, leaving the prompt+output prefix
        cached under ``sid`` (replacing any shorter entry) for same-session
        follow-ups."""
        a = self.allocs.pop(rid, None)
        if a is None:
            raise KVError(f"release of unknown request {rid}")
        blocks = a.shared + a.owned
        if self.cfg.prefix_cache and sid >= 0:
            bs = self.cfg.block_size
            keep_tokens = min((ctx_tokens // bs) * bs, len(blocks) * bs)
            keep = blocks[:keep_tokens // bs]
            if keep:
                for b in keep:           # entry refs before allocation derefs
                    self._incref(b)
                if sid in self.sessions:
                    self._drop_entry(sid)
                self.sessions[sid] = _CacheEntry(tuple(keep), keep_tokens, t)
        for b in blocks:
            self._hard_dec(b)
            self._decref(b)

    def drop(self, rid: int):
        """Evict with KV discarded (recompute on re-admission)."""
        a = self.allocs.pop(rid, None)
        if a is None:
            raise KVError(f"drop of unknown request {rid}")
        for b in a.shared + a.owned:
            self._hard_dec(b)
            self._decref(b)

    # ---- swap flows ---------------------------------------------------
    def owned_blocks(self, rid: int) -> int:
        a = self.allocs.get(rid)
        return len(a.owned) if a else 0

    def swap_out(self, rid: int) -> tuple[str, float]:
        """Pause-requeue: move ``rid``'s owned blocks to the DRAM tier
        (shared prefix blocks just unref — they stay cached for others).
        Returns ("swap", bytes_moved) or, when the tier is full,
        ("drop", bytes_discarded) — the recompute fallback."""
        a = self.allocs.pop(rid, None)
        if a is None:
            raise KVError(f"swap_out of unknown request {rid}")
        for b in a.shared:
            self._hard_dec(b)
            self._decref(b)
        n = len(a.owned)
        nbytes = n * self.cfg.block_bytes
        if 0 < n <= self.dram_free:
            self.dram_free -= n
            self.tickets[rid] = n
            for b in a.owned:
                if self.ref.get(b) != 1:
                    raise KVError(f"owned block {b} has foreign refs")
                self._hard_dec(b)
                self._decref(b)
            self.stats.swap_outs += 1
            self.stats.offload_bytes += nbytes
            return "swap", nbytes
        for b in a.owned:
            self._hard_dec(b)
            self._decref(b)
        return "drop", nbytes

    def swap_in_release(self, rid: int) -> int:
        """The swapped victim was re-admitted (here or elsewhere): release
        its DRAM ticket."""
        n = self.tickets.pop(rid, 0)
        self.dram_free += n
        if n:
            self.stats.swap_ins += 1
        return n

    # ---- crash teardown ------------------------------------------------
    def purge(self):
        """Crash teardown (sim.faults): the box's memory is gone, so every
        allocation, arrival pin, cached prefix, and swap ticket is
        discarded in one sweep.  Leaves the allocator empty-but-consistent
        — ``check()`` passes, ``busy`` releases — so a dead husk audits
        clean while it waits for the health monitor to reap it.  In-flight
        arrivals that pinned a prefix here fall through to the existing
        pin-lost path (``unpin`` tolerates the missing pin)."""
        for rid in list(self.pins):
            self.unpin(rid)
        for rid in list(self.allocs):
            self.drop(rid)
        for key in list(self.sessions):
            self._drop_entry(key)
        self.dram_free += sum(self.tickets.values())
        self.tickets.clear()
        # pins drained first, so no entry can have been parked as retired
        self._retired.clear()
        self._mutated()

    # ---- invariants ----------------------------------------------------
    def check(self):
        """Double-entry audit: re-derive every refcount from allocations +
        pins + cache entries and compare.  Blocks never leak, are never
        double-freed, and the two tiers always sum to their capacities."""
        expect: Counter = Counter()
        hard_expect: Counter = Counter()
        for a in self.allocs.values():
            for b in a.shared + a.owned:
                expect[b] += 1
                hard_expect[b] += 1
        for p in self.pins.values():
            for b in p.ids:
                expect[b] += 1
                hard_expect[b] += 1
        for e in self.sessions.values():
            for b in e.ids:
                expect[b] += 1
        if dict(expect) != self.ref:
            raise KVError(f"ref drift: expected {dict(expect)}, "
                          f"have {self.ref}")
        if dict(hard_expect) != self.hard:
            raise KVError("hard-ref drift")
        if self.hard_used != len(hard_expect):
            raise KVError("hard_used drift")
        if set(self.free) & set(self.ref):
            raise KVError("block both free and referenced")
        if len(self.free) != len(set(self.free)):
            raise KVError("duplicate free-list entry")
        if len(self.free) + len(self.ref) != self.cfg.n_hbm:
            raise KVError(
                f"HBM blocks leaked: {len(self.free)} free + "
                f"{len(self.ref)} referenced != {self.cfg.n_hbm}")
        dram_held = sum(self.tickets.values()) + sum(
            e.dram_blocks for e in self.sessions.values()
            if e.tier == "dram")
        if self.dram_free + dram_held != self.cfg.n_dram:
            raise KVError("DRAM blocks leaked")
        # ---- no-stale-pins invariant (the pin-leak audit): every pin
        # references a tracked entry, every entry's pin count equals the
        # pins actually referencing it, and the retired list holds exactly
        # the dropped-but-still-pinned entries (storage already freed) ----
        live = {id(e): e for e in self.sessions.values()}
        retired = {id(e): e for e in self._retired}
        pin_counts: Counter = Counter()
        for rid, p in self.pins.items():
            eid = id(p.entry)
            if eid not in live and eid not in retired:
                raise KVError(f"stale pin {rid}: entry neither live "
                              f"nor retired")
            pin_counts[eid] += 1
        for eid, e in {**live, **retired}.items():
            if e.pins != pin_counts.get(eid, 0):
                raise KVError(f"entry pin-count drift: {e.pins} recorded, "
                              f"{pin_counts.get(eid, 0)} actual")
        for e in self._retired:
            if e.pins <= 0:
                raise KVError("retired entry with no pins")
            if e.ids or e.dram_blocks:
                raise KVError("retired entry still holds storage")
