"""KV-locality-aware gateway: fleet-level prefix hashtrie + routing score.

The per-session prefix cache made reuse *possible* but placement stayed
owner-steered: an arrival only benefits from a cached prefix when
admission happens to land on the single decoder that owns its session
chain, and cross-session reuse (the hot system prompt every tenant
prepends) is invisible to the per-session lookup.  This module is the
control-plane half of locality-aware placement (DESIGN.md "Routing
fidelity"):

  * **Block-granular prefix hashtrie** — prompts are split into
    fixed-size token blocks and each block gets a deterministic content
    label (see ``prefix_chain``); the trie is a radix over those label
    chains, fleet-wide: every node records *which decoders* hold the
    prefix it spells, so one lookup maps an arrival to the set of
    decoders holding *any* prefix of it — per-session chains and
    cross-session shared system prompts alike.
  * **Locality-aware routing score** — candidates are ranked by
    ``cached_suffix_savings - alpha * queue_depth`` (DistServe's goodput
    trade stated as a placement rule): a deep cached prefix is worth
    routing to a busier box only while the prefill tokens it saves
    outweigh the queueing it buys.  Ties and misses fall back to the
    share-of-capacity balancer (``core.router.Router.route_decode``).
  * **Hot-prefix replication plan** — nodes whose hit rate over a
    sliding window crosses a threshold are flagged; the cluster copies
    them to additional decoders over the interconnect (charged at
    ``KVAllocator.migration_stall`` cost) so a hot prefix stops
    funneling traffic to one box.

The trie is *advisory*: allocators (``sim.kvcache.KVAllocator``) remain
the ground truth for what is actually resident.  Holder entries are
validated against the owner's allocator at routing time and dropped
lazily when stale, so eviction inside an allocator never needs a
callback into the gateway.

Determinism: children and holders are insertion-ordered dicts keyed by
label tuples / holder objects — iteration order is insertion order,
never hash order — so routing decisions are reproducible run-to-run
(the gateway golden pins this).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional


@dataclass(frozen=True)
class GatewayConfig:
    """Knobs for the locality gateway (defaults are the bench setting)."""
    #: queue-depth penalty: cached tokens a unit of queue depth is worth.
    #: The score is ``saved_tokens - alpha * len(active)``; alpha is in
    #: tokens-per-resident-request, so ~one decode iteration's worth of
    #: prefill savings must be on the table before the gateway prefers a
    #: busier box over the balancer's pick.
    alpha: float = 64.0
    #: window hits at which a prefix counts as hot (sliding window).
    replicate_threshold: int = 8
    #: total copies (including the origin) a hot prefix is grown to.
    replicate_copies: int = 2
    #: sliding window (seconds) for the hit-rate estimate.
    window_s: float = 10.0
    #: trie capacity in nodes; least-recently-hit chains age out beyond it.
    max_nodes: int = 4096
    #: prefixes shorter than this are never worth replicating.
    min_tokens: int = 64


@dataclass
class RoutingStats:
    """Gateway decision/replication counters — ``SimReport.gw``.

    Kept separate from ``sim.kvcache.KVStats`` on purpose: the kvtiers
    golden pins ``KVStats.summary()``'s schema, so gateway counters get
    their own sink (empty dict when no pool enables the gateway).
    """
    affinity_hits: int = 0        # routed to a decoder already holding KV
    replica_hits: int = 0         # ...where that holder was a replica copy
    balanced: int = 0             # no usable prefix: share-of-capacity path
    steered_tokens: int = 0       # prompt tokens served by gateway routing
    replications: int = 0         # completed hot-prefix copies
    replica_bytes: float = 0.0    # bytes shipped by those copies
    replica_stall_s: float = 0.0  # interconnect time charged for them
    block_grows: int = 0          # lazy-alloc per-token block extensions
    grow_failures: int = 0        # extensions that found no block free
    oom_preemptions: int = 0      # mid-decode evictions those triggered

    def summary(self) -> dict:
        return {
            "affinity_hits": self.affinity_hits,
            "replica_hits": self.replica_hits,
            "balanced": self.balanced,
            "steered_tokens": self.steered_tokens,
            "replications": self.replications,
            "replica_bytes": self.replica_bytes,
            "replica_stall_s": self.replica_stall_s,
            "block_grows": self.block_grows,
            "grow_failures": self.grow_failures,
            "oom_preemptions": self.oom_preemptions,
        }


def prefix_chain(shared_id: int, shared_len: int, session: int,
                 in_len: int, block_size: int) -> list[tuple]:
    """Deterministic content labels for a prompt's full blocks.

    In a real serving gateway each label would be the hash of the block's
    tokens chained onto its parent (vLLM/SGLang-style prefix hashing).
    The simulator has no token text, but it *does* know the two provable
    sources of content equality the trace encodes: a Zipf-shared system
    prompt (``shared_id`` covers the first ``shared_len`` tokens,
    identical across sessions) and same-session history (a session's
    follow-up extends its own previous context verbatim).  Labels encode
    exactly those equivalences:

      * block ``i`` fully inside the shared prompt -> ``("sys", shared_id,
        i)`` — equal across *all* requests sharing the prompt;
      * remaining full blocks of a sessionful request -> ``("sess",
        session, i)`` — equal across that session's turns;
      * sessionless tails produce no labels (no provable reuse).

    A block straddling the shared-prompt boundary is a session block: its
    content mixes shared and private tokens, so it is only equal within
    the session.  The chain is therefore a prefix-closed spelling of the
    request's reusable content, and two requests share cached state
    exactly when their chains share a prefix.
    """
    if block_size <= 0 or in_len < block_size:
        return []
    n_full = in_len // block_size
    n_sys = 0
    if shared_id >= 0 and shared_len > 0:
        n_sys = min(shared_len // block_size, n_full)
    chain: list[tuple] = [("sys", shared_id, i) for i in range(n_sys)]
    if session >= 0:
        chain += [("sess", session, i) for i in range(n_sys, n_full)]
    return chain


class _Node:
    """One trie node: the prefix spelled by the path from the root."""

    __slots__ = ("label", "depth", "children", "holders", "hits",
                 "last_use", "pending")

    def __init__(self, label: Optional[tuple], depth: int):
        self.label = label
        self.depth = depth                      # tokens covered by the path
        self.children: dict[tuple, _Node] = {}
        # holder -> [last_use, is_replica]; insertion-ordered (determinism)
        self.holders: dict[object, list] = {}
        self.hits: list[float] = []             # hit timestamps (window)
        self.last_use = 0.0
        self.pending = False                    # replication in flight

    def hit_rate(self, t: float, window: float) -> int:
        """Hits inside the sliding window ending at ``t``."""
        h = self.hits
        cut = t - window
        while h and h[0] < cut:
            h.pop(0)
        return len(h)


class PrefixHashTrie:
    """Fleet-level radix over block-label chains (see module docstring).

    ``insert`` marks ``holder`` on every node along the chain (holding a
    prefix implies holding all its prefixes); ``lookup`` walks the chain
    and reports, per holder, the deepest node it appears on.  Both are
    O(chain length).  The trie never exceeds ``max_nodes``: beyond it the
    least-recently-used leaf chains age out (holders are advisory, so
    aging out a node only costs future routing opportunities, never
    correctness).
    """

    def __init__(self, max_nodes: int = 4096):
        self.root = _Node(None, 0)
        self.max_nodes = max_nodes
        self.n_nodes = 0

    # ---- mutation ----------------------------------------------------
    def insert(self, chain: Iterable[tuple], holder: object, t: float,
               block_size: int, replica: bool = False):
        """Record that ``holder`` caches the prefix spelled by ``chain``."""
        node = self.root
        for label in chain:
            child = node.children.get(label)
            if child is None:
                child = _Node(label, node.depth + block_size)
                node.children[label] = child
                self.n_nodes += 1
            node = child
            node.last_use = t
            ent = node.holders.get(holder)
            if ent is None:
                node.holders[holder] = [t, replica]
            else:
                ent[0] = t
                # an origin insert upgrades a replica marking, never the
                # reverse (a replica copy of something already held adds
                # no information)
                if not replica:
                    ent[1] = False
        if self.n_nodes > self.max_nodes:
            self._prune(t)

    def remove_holder(self, holder: object):
        """Forget every marking of ``holder`` (decoder torn down)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            node.holders.pop(holder, None)
            stack.extend(node.children.values())

    def _prune(self, t: float):
        """Age out least-recently-used subtrees until under capacity.

        Candidates are collected deterministically (preorder, insertion
        order) and dropped oldest-first; a dropped node takes its whole
        subtree (children are by construction no younger in ``last_use``
        than the ancestors that led to them only on the hit path, so
        subtree drops may discard fresher grandchildren — acceptable for
        an advisory cache, and it keeps pruning O(nodes))."""
        # (last_use, seq, parent, label) per depth-1..n node
        cands: list[tuple[float, int, _Node, tuple]] = []
        seq = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            for label, child in node.children.items():
                cands.append((child.last_use, seq, node, label))
                seq += 1
                stack.append(child)
        cands.sort(key=lambda c: (c[0], c[1]))
        target = int(self.max_nodes * 0.75)
        dead: set[int] = set()      # nodes gone with an ancestor's subtree
        for _, _, parent, label in cands:
            if self.n_nodes <= target:
                break
            if id(parent) in dead:  # detached parents still hold children;
                continue            # popping there would double-count
            child = parent.children.pop(label, None)
            if child is None:
                continue
            sub = [child]
            while sub:
                node = sub.pop()
                dead.add(id(node))
                self.n_nodes -= 1
                sub.extend(node.children.values())

    # ---- queries -----------------------------------------------------
    def lookup(self, chain: list[tuple], t: float
               ) -> dict[object, tuple[int, "_Node"]]:
        """Deepest marked node per holder along ``chain``.

        Returns ``{holder: (depth_tokens, node)}`` in first-seen holder
        order.  Records a window hit on the deepest node reached (the
        replication signal counts *prefix* popularity, so the hit lands
        on the longest matched path, not every ancestor)."""
        out: dict[object, tuple[int, _Node]] = {}
        node = self.root
        for label in chain:
            child = node.children.get(label)
            if child is None:
                break
            node = child
            node.last_use = t
            for holder in node.holders:
                out[holder] = (node.depth, node)
        if node is not self.root:
            node.hits.append(t)
        return out

    def walk(self, chain: list[tuple]) -> Optional[_Node]:
        """The node spelling ``chain`` exactly, or None."""
        node = self.root
        for label in chain:
            node = node.children.get(label)
            if node is None:
                return None
        return node

    def holders_of(self, chain: list[tuple]) -> list:
        node = self.walk(chain)
        return list(node.holders) if node is not None else []

    def check(self, block_size: int):
        """Structural audit (test hook): depths are consistent, node
        count matches the tree, no empty labels."""
        n = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            for label, child in node.children.items():
                if child.label != label:
                    raise AssertionError("child label drift")
                if child.depth != node.depth + block_size:
                    raise AssertionError("depth drift")
                n += 1
                stack.append(child)
        if n != self.n_nodes:
            raise AssertionError(
                f"node count drift: counted {n}, tracked {self.n_nodes}")


@dataclass
class ReplicationJob:
    """One planned hot-prefix copy, serviced by the cluster."""
    chain: tuple                   # label chain of the replicated prefix
    key: tuple                     # allocator cache key on the target
    tokens: int
    source: object                 # origin decoder (owns the blocks)
    target: object                 # destination decoder
    t_done: float = 0.0            # completion time (stamped by cluster)
    node: object = None            # trie node (pending flag cleared there)
    gw: object = None              # owning Gateway (stamped by cluster)


class Gateway:
    """Per-model-group locality gateway: trie + score + replication plan.

    The cluster calls ``route`` per arrival and ``observe_release`` when
    a finished request's blocks become a cache entry; ``plan_replication``
    turns window-hot trie nodes into ``ReplicationJob``s the cluster
    executes with real interconnect cost.
    """

    def __init__(self, cfg: GatewayConfig, block_size: int,
                 stats: Optional[RoutingStats] = None):
        self.cfg = cfg
        self.block_size = block_size
        self.stats = stats or RoutingStats()
        self.trie = PrefixHashTrie(cfg.max_nodes)
        # flight-recorder tap (repro_torch.obs): hook(t, kind, **fields) for
        # replication-lifecycle events; None (default) = telemetry off,
        # one attribute test on the replication-planning path only.
        self.trace_hook = None

    # ---- chain plumbing ----------------------------------------------
    def chain_of(self, src) -> list[tuple]:
        """Label chain for a trace request (``sim.traces.TraceRequest``)."""
        return prefix_chain(
            getattr(src, "shared_id", -1), getattr(src, "shared_len", 0),
            getattr(src, "session", -1), src.in_len, self.block_size)

    @staticmethod
    def cache_key(node_label: tuple, session: int):
        """Allocator cache key for the entry backing a trie path ending
        at ``node_label``: session chains live under the session id (the
        legacy key, so session follow-ups and the gateway see one entry);
        shared-prompt chains live under ``("sys", shared_id)``."""
        if node_label[0] == "sys":
            return ("sys", node_label[1])
        return session

    # ---- routing -----------------------------------------------------
    def best_holder(self, chain: list[tuple], t: float,
                    live: "callable") -> Optional[tuple]:
        """Highest-scoring holder of any prefix of ``chain``.

        ``live(holder)`` filters candidates (ready, not draining, has an
        allocator); stale holders — marked in the trie but no longer
        backing the entry in their allocator — are dropped lazily here.
        Returns ``(holder, node, depth_tokens, is_replica, score)`` or
        None when no live holder scores above the balanced fallback
        (score <= -alpha * min queue depth is still returned; the caller
        compares against its own fallback)."""
        found = self.trie.lookup(chain, t)
        best = None
        for holder, (depth, node) in found.items():
            if not live(holder):
                node.holders.pop(holder, None)
                continue
            score = float(depth) \
                - self.cfg.alpha * len(getattr(holder, "active", ()))
            ent = node.holders.get(holder)
            replica = bool(ent and ent[1])
            if best is None or score > best[4]:
                best = (holder, node, depth, replica, score)
        return best

    # ---- replication -------------------------------------------------
    def plan_replication(self, chain: list[tuple], t: float,
                         decoders: list) -> list[ReplicationJob]:
        """Hot-prefix check for the deepest *shared* node of ``chain``:
        when its window hit count crosses the threshold and it has fewer
        than ``replicate_copies`` holders, plan copies to the
        least-loaded non-holders.  Session-private chains never
        replicate (their reuse is single-stream by construction)."""
        cfg = self.cfg
        n_sys = 0
        for label in chain:
            if label[0] != "sys":
                break
            n_sys += 1
        if n_sys == 0:
            return []
        node = self.trie.walk(chain[:n_sys])
        if node is None or node.pending or node.depth < cfg.min_tokens:
            return []
        if node.hit_rate(t, cfg.window_s) < cfg.replicate_threshold:
            return []
        holders = [h for h in node.holders]
        if not holders or len(holders) >= cfg.replicate_copies:
            return []
        src = holders[0]
        targets = [d for d in decoders
                   if d not in node.holders and d.kv is not None]
        targets.sort(key=lambda d: (len(d.active), d.iid))
        jobs = []
        key = self.cache_key(node.label, -1)
        for tgt in targets[:cfg.replicate_copies - len(holders)]:
            jobs.append(ReplicationJob(
                chain=tuple(chain[:n_sys]), key=key, tokens=node.depth,
                source=src, target=tgt, node=node))
        if jobs:
            node.pending = True
            if self.trace_hook is not None:
                self.trace_hook(
                    t, "planned", tokens=node.depth, copies=len(jobs),
                    source=getattr(src, "iid", None),
                    targets=[getattr(j.target, "iid", None) for j in jobs])
        return jobs
