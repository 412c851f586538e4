"""Sharded, refcounted paged-KV pool with prefix caching and a host-DRAM
spill tier (host-side, pure Python).

A port of the JAX package's ``cache/block_manager.py``, kept close to
verbatim so both allocators hand out the same pages for the same request
stream and place a request on the same page-range shard. In this port the
engine leaves the spill and prefetch hooks unset (the host tier is not
served yet).

The device cache is ONE preallocated paged pool shared by every sequence
(model ``init_cache`` — leaves shaped ``(2, P_total, ps, Hkv, D)`` with no batch
dimension) and all dynamic paging happens here as *indices*: each sequence
owns a logical-ordered list of physical pages; token slot =
page_table[pos // ps] * ps + pos % ps, a *global* flat slot.

Design (paper §2 "allocator mismatch" + Opt-KV Eq. 5 + Opt-Pa §3.3):

* **Page-range sharding** — the pool's ``pages`` axis is split into
  ``num_shards`` contiguous page ranges (the ``(pod, data)`` extent of a
  ``launch.mesh`` mesh; with the kernels each range is then a pool of its
  own on its shard's device, ``core.opt_kv.ShardedPool``). Shard s owns
  ``shard_page_ranges(num_pages, num_shards)[s]`` and keeps its OWN free
  list, LRU and prefix-hash table.
  A sequence is pinned to one shard at ``allocate`` time and only ever
  draws pages from that shard's range, so its page table never leaves its
  shard. ``OutOfBlocks`` carries the pressured shard so the scheduler can
  preempt *on that shard*.
* **Refcounts** — a physical page may back several sequences (shared prompt
  prefix). Writers only ever touch pages they exclusively own: the trailing
  partial page of a prompt and decode-appended pages are always fresh, so
  sharing is copy-on-write by construction (a shared page is never written).
* **Prefix caching** — full pages of a prompt are registered under a chain
  hash ``h_i = H(h_{i-1}, tokens_of_page_i)`` once their KV has actually been
  computed (``commit_prefill``), in the owning shard's table. ``allocate``
  walks the chain within the sequence's shard and reuses every leading
  full-page hit; ``preferred_shard`` exposes where a prompt's chain-hash head
  lives so the scheduler can place for shard-local CoW reuse. At least one
  prompt token is always left uncached so prefill still emits logits.
* **LRU eviction** — when the last reference to a registered page drops, the
  page parks in its shard's cached-but-unreferenced LRU list instead of the
  free list; allocation pressure evicts from its cold end (hash entry
  removed, page recycled). ``OutOfBlocks`` is raised only when the shard's
  free + evictable both run dry.
* **SkipSet** — the manager emits slot indices of -1 for tokens the policy
  says never to cache (padding, prefix-cache hits, out-of-window tokens), so
  the device-side scatter drops them without touching memory (Eq. 5).

Residency state machine (hierarchical cache, ``CacheConfig.host_pages``)
========================================================================

Every chain hash is in exactly ONE residency state (``PageResidency``)::

                  commit_prefill            LRU eviction + spill_sink
      DROPPED  ────────────────►  DEVICE  ──────────────────────────►  HOST
         ▲                          ▲                                   │
         │ spill_sink refuses /     │ commit_prefetch                   │
         │ host-LRU eviction        │ (next scheduler turn)             │
         └───────── HOST ◄──────────┴───────────── IN_FLIGHT ◄──────────┘
                     ▲           abort_prefetch        begin_prefetch
                     └─────────────────────────────────┘

* DEVICE    — registered in some shard's prefix-hash table; ``allocate``
              can reuse the page directly (refcount bump, zero recompute).
* HOST      — the page's quantized contents live in the host-DRAM store
              (``spill_sink`` slices them out of the pool at eviction);
              matched-but-not-resident, reusable only after a prefetch.
* IN_FLIGHT — ``begin_prefetch`` reserved a device staging page and the
              engine dispatched the host→HBM upload; the hash commits to
              the device table at the NEXT scheduler turn (device dispatch
              order guarantees the upload lands before any later step
              reads the page — no host sync is ever needed to "wait").
* DROPPED   — nowhere: never cached, spilled and then host-LRU-evicted,
              or the spill sink refused (fault injection / tier off).

Two-tier invariants (checked by ``audit()``):

  * the host store and the device tables are DISJOINT on hashes — a hash
    lives in at most one tier (``commit_prefill``/``commit_prefetch`` drop
    the host copy when the hash re-registers on device);
  * staging pages are a fourth page home (free / cached-LRU / referenced /
    staging): reserved in their shard's range, never registered, never
    refcounted;
  * the host store never exceeds ``host_pages`` entries (its own LRU
    evicts to DROPPED);
  * an IN_FLIGHT hash owns its payload exclusively (popped from the host
    store at ``begin_prefetch``; returned on abort, dropped on commit).
"""
from __future__ import annotations

import enum
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import CacheConfig


def padded_pool_pages(num_pages: int, num_shards: int) -> int:
    """Device page count rounded up so the ``pages`` axis splits evenly into
    ``num_shards`` page ranges. Models' ``init_cache`` (through
    ``core.opt_kv.pool_layout``) and the scheduler's pool sizing agree on
    this, so host page ids == device page ids."""
    s = max(int(num_shards), 1)
    return ((num_pages + s - 1) // s) * s


def shard_page_ranges(num_pages: int,
                      num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` page ranges owned by each shard — the host
    mirror of the device pages-axis sharding. Splits like
    ``np.array_split``: the first ``num_pages % num_shards`` shards get one
    extra page. When the device pool is ``padded_pool_pages`` wide and the
    final page is reserved (write-kernel SkipSet sentinel), the usable
    ``num_pages = P_dev - 1`` splits so every boundary coincides with a
    device shard boundary and only the LAST shard loses the sentinel page.
    """
    s = max(int(num_shards), 1)
    base, rem = divmod(num_pages, s)
    ranges, lo = [], 0
    for i in range(s):
        hi = lo + base + (1 if i < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be served. ``shard`` names the
    pressured shard (always set by a sharded manager) so the scheduler can
    target preemption."""

    def __init__(self, msg: str, shard: int = 0):
        super().__init__(msg)
        self.shard = shard


class PageResidency(enum.Enum):
    """Where a chain-hashed prefix page currently lives (see the module
    docstring's state machine)."""
    DEVICE = "device"
    HOST = "host"
    IN_FLIGHT = "in_flight"
    DROPPED = "dropped"


class PageHome(enum.Enum):
    """Which allocator structure owns a PHYSICAL device page right now.
    Exactly one home per page — ``audit()`` invariant 1."""
    FREE = "free"            # on its shard's free list
    CACHED = "cached"        # registered, refcount 0, parked in the LRU
    REFERENCED = "referenced"  # held by >= 1 live sequence
    STAGING = "staging"      # reserved for an IN_FLIGHT host->HBM upload


@dataclass(frozen=True)
class PageState:
    """Public page-level state record (replaces the informal tuples and the
    ``_free``/``_lru`` flat-view accessors)."""
    page: int
    shard: int
    home: PageHome
    refcount: int = 0
    hash: Optional[int] = None


@dataclass(frozen=True)
class MatchedPage:
    """One chain-hash probe result of ``match_prefix``: the page ordinal
    within the prompt, its hash, where it lives, and — when device-backed
    (DEVICE / IN_FLIGHT) — the physical page id."""
    index: int
    hash: int
    residency: PageResidency
    page: int = -1


@dataclass(frozen=True)
class PrefixMatch:
    """Residency-first prefix-match result: the longest leading run of the
    prompt's full pages that is *somewhere* (device, host, or in flight),
    gate-trimmed. ``allocate`` can only reuse the DEVICE entries directly;
    the scheduler prefetches the rest before admission."""
    shard: int
    pages: Tuple[MatchedPage, ...] = ()

    def count(self, residency: PageResidency) -> int:
        return sum(1 for p in self.pages if p.residency is residency)

    @property
    def device_pages(self) -> int:
        return self.count(PageResidency.DEVICE)

    @property
    def fetchable(self) -> Tuple[MatchedPage, ...]:
        """Pages that need a host->HBM prefetch (or are already in flight)
        before ``allocate`` on this shard could reuse them."""
        return tuple(p for p in self.pages
                     if p.residency is not PageResidency.DEVICE)


@dataclass
class SeqBlocks:
    pages: List[int] = field(default_factory=list)
    num_tokens: int = 0
    cached_tokens: int = 0        # leading tokens served by the prefix cache
    committed_pages: int = 0      # full pages registered in the hash table
    committed_hash: int = 0       # running chain hash after committed_pages
                                  # (commit_prefill extends incrementally)
    shard: int = 0                # owning shard — all pages stay in its range


@dataclass
class _Staging:
    """One IN_FLIGHT prefetch: the reserved device page and the host
    payload the upload was built from (kept for retry-on-abort)."""
    page: int
    shard: int
    payload: Any


def _chain_hash(prev: int, toks: Sequence[int]) -> int:
    return hash((prev, tuple(int(t) for t in toks)))


def extend_chain_hash(h: int, token_ids: Sequence[int], from_page: int,
                      to_page: int, page_size: int) -> int:
    """Extend a running chain hash from ``from_page`` to ``to_page`` —
    incremental form so hot paths never rehash from page 0 (O(pages) per
    request instead of O(pages^2) across its chunk ends)."""
    for i in range(from_page, to_page):
        h = _chain_hash(h, token_ids[i * page_size:(i + 1) * page_size])
    return h


def chain_hash_tokens(token_ids: Sequence[int], num_pages: int,
                      page_size: int) -> int:
    """Chain hash of the first ``num_pages`` full pages of ``token_ids`` —
    the key under which those pages are registered in the prefix table.
    Engines use it to key side-band resume artifacts (e.g. recurrent-state
    snapshots at committed page boundaries) to the same identity."""
    return extend_chain_hash(0, token_ids, 0, num_pages, page_size)


class BlockManager:
    """Refcounted free-list allocator over ONE pool of ``cfg.num_pages``
    pages (the USABLE device page count — the caller has already padded the
    pool and reserved its final page), partitioned into ``cfg.num_shards``
    contiguous page ranges, with an optional host-DRAM spill tier (module
    docstring)."""

    def __init__(self, cfg: CacheConfig):
        if cfg.num_pages <= 0 or cfg.page_size <= 0:
            raise ValueError("BlockManager needs a resolved CacheConfig "
                             f"(num_pages/page_size > 0), got {cfg}")
        self.cfg = cfg
        self.num_pages = cfg.num_pages
        self.page_size = cfg.page_size
        self.enable_prefix_cache = cfg.enable_prefix_cache
        self.num_shards = max(int(cfg.num_shards), 1)
        self.host_pages = cfg.host_pages
        self.shard_ranges: List[Tuple[int, int]] = \
            shard_page_ranges(self.num_pages, self.num_shards)
        self._shard_starts = np.asarray([lo for lo, _ in self.shard_ranges])
        # per-shard allocator state
        self._free_by_shard: List[List[int]] = [
            list(range(hi - 1, lo - 1, -1)) for lo, hi in self.shard_ranges]
        self._lru_by_shard: List["OrderedDict[int, None]"] = [
            OrderedDict() for _ in range(self.num_shards)]
        self._hash_by_shard: List[Dict[int, int]] = [
            {} for _ in range(self.num_shards)]
        self._page_to_hash: Dict[int, int] = {}
        self._seqs: Dict[int, SeqBlocks] = {}
        self._ref: Dict[int, int] = {}                 # page -> refcount
        # Optional hash -> bool veto consulted during prefix matching.
        # Recurrent-state families (griffin/rwkv6) set this to "a state
        # snapshot exists for this prefix": reusing KV pages without the
        # recurrent state at that boundary would skip tokens the state has
        # never seen, so a match requires BOTH.
        self.prefix_gate = None
        # ------------------------------------------------- host-DRAM tier --
        # hash -> payload LRU (capacity host_pages); payloads are opaque to
        # the manager — the engine's spill sink produces them and its
        # prefetch path consumes them
        self._host: "OrderedDict[int, Any]" = OrderedDict()
        self._staging: Dict[int, _Staging] = {}        # hash -> IN_FLIGHT
        # engine-provided (h, page, shard) -> payload | None; None means
        # the page could not be spilled (tier off / fault) and is DROPPED
        self.spill_sink: Optional[Callable[[int, int, int], Any]] = None
        # hashes whose device copy arrived via prefetch; consumed (once)
        # by the next allocate that prefix-hits them, splitting hit
        # attribution into device- vs host-served
        self._host_sourced: set = set()
        # ------------------------------------------------------------ stats --
        self.prefix_queries = 0       # full prompt pages looked up
        self.prefix_hits = 0          # full prompt pages served from cache
        self.prefix_device_hits = 0   # ... of which were device-resident
        self.prefix_host_hits = 0     # ... of which the host tier restored
        self.evictions = 0
        self.fresh_pages_allocated = 0  # pages handed out (not prefix hits)
        self.spilled_pages = 0        # evictions captured by the host tier
        self.host_evictions = 0       # host-LRU drops (HOST -> DROPPED)
        self.prefetch_begun = 0
        self.prefetch_committed = 0
        self.prefetch_aborted = 0

    # ------------------------------------------------------------- queries --
    @property
    def host_tier_enabled(self) -> bool:
        return self.host_pages > 0 and self.spill_sink is not None

    @property
    def free_pages(self) -> int:
        return sum(len(fl) for fl in self._free_by_shard)

    @property
    def evictable_pages(self) -> int:
        return sum(len(lru) for lru in self._lru_by_shard)

    @property
    def staging_pages(self) -> int:
        return len(self._staging)

    @property
    def host_resident_pages(self) -> int:
        return len(self._host)

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one live sequence."""
        return (self.num_pages - self.free_pages - self.evictable_pages
                - self.staging_pages)

    def shard_of(self, page: int) -> int:
        """Owning shard of a physical page id."""
        return int(np.searchsorted(self._shard_starts, page, "right") - 1)

    def shard_capacity(self, shard: int) -> int:
        lo, hi = self.shard_ranges[shard]
        return hi - lo

    def max_shard_capacity(self) -> int:
        return max(hi - lo for lo, hi in self.shard_ranges)

    def free_pages_in(self, shard: int) -> int:
        return len(self._free_by_shard[shard])

    def evictable_pages_in(self, shard: int) -> int:
        return len(self._lru_by_shard[shard])

    def staging_pages_in(self, shard: int) -> int:
        return sum(1 for st in self._staging.values() if st.shard == shard)

    def pages_in_use_in(self, shard: int) -> int:
        return (self.shard_capacity(shard) - self.free_pages_in(shard)
                - self.evictable_pages_in(shard)
                - self.staging_pages_in(shard))

    def seq_shard(self, seq_id: int) -> int:
        return self._seqs[seq_id].shard

    def utilization(self) -> float:
        return self.pages_in_use / self.num_pages if self.num_pages else 0.0

    def shard_utilization(self, shard: int) -> float:
        cap = self.shard_capacity(shard)
        return self.pages_in_use_in(shard) / cap if cap else 0.0

    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_queries \
            if self.prefix_queries else 0.0

    def page_states(self) -> Dict[int, PageState]:
        """Every physical page's public state record — the ONE sanctioned
        view of the allocator's structures (the old ``_free``/``_lru``
        flat-view accessors are gone). O(pages); not for the hot path."""
        out: Dict[int, PageState] = {}
        for s in range(self.num_shards):
            for p in self._free_by_shard[s]:
                out[p] = PageState(p, s, PageHome.FREE)
            for p in self._lru_by_shard[s]:
                out[p] = PageState(p, s, PageHome.CACHED,
                                   hash=self._page_to_hash.get(p))
        for h, st in self._staging.items():
            out[st.page] = PageState(st.page, st.shard, PageHome.STAGING,
                                     hash=h)
        for p, r in self._ref.items():
            out[p] = PageState(p, self.shard_of(p), PageHome.REFERENCED,
                               refcount=r, hash=self._page_to_hash.get(p))
        return out

    def residency(self, h: int) -> PageResidency:
        """Residency of a chain hash (DEVICE takes priority — the staging /
        host records of a hash die when it re-registers on device)."""
        if any(h in t for t in self._hash_by_shard):
            return PageResidency.DEVICE
        if h in self._staging:
            return PageResidency.IN_FLIGHT
        if h in self._host:
            return PageResidency.HOST
        return PageResidency.DROPPED

    def residency_counts(self) -> Dict[PageResidency, int]:
        """Population of each residency state (DROPPED is unbounded and
        reported as 0)."""
        return {PageResidency.DEVICE: len(self._page_to_hash),
                PageResidency.HOST: len(self._host),
                PageResidency.IN_FLIGHT: len(self._staging),
                PageResidency.DROPPED: 0}

    def shared_page_counts(self) -> Dict[int, int]:
        """Physical pages held by more than one live sequence, with their
        refcounts. These are exactly the pages the cross-lane visit grid
        (kernels.visits) can batch when the holders decode in one step."""
        return {p: r for p, r in self._ref.items() if r > 1}

    def sharing_histogram(self) -> Dict[int, int]:
        """Histogram refcount -> number of shared pages (refcount > 1)."""
        hist: Dict[int, int] = {}
        for r in self.shared_page_counts().values():
            hist[r] = hist.get(r, 0) + 1
        return hist

    def can_allocate(self, num_tokens: int,
                     shard: Optional[int] = None) -> bool:
        need = (num_tokens + self.page_size - 1) // self.page_size
        if shard is not None:
            return need <= (self.free_pages_in(shard)
                            + self.evictable_pages_in(shard))
        return any(need <= self.free_pages_in(s) + self.evictable_pages_in(s)
                   for s in range(self.num_shards))

    def num_tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].num_tokens

    def cached_tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].cached_tokens

    # ---------------------------------------------------------- placement --
    def preferred_shard(self, token_ids: Optional[Sequence[int]],
                        num_tokens: int) -> Optional[int]:
        """Shard where this prompt's chain-hash HEAD (first full page) is
        registered, or None — the scheduler's prefix-affinity placement
        hint (reuse is only possible shard-locally)."""
        if (not self.enable_prefix_cache or token_ids is None
                or num_tokens <= self.page_size):
            return None
        # restorability (prefix_gate) is deliberately NOT consulted here:
        # placement affinity only needs to know where the prompt's pages
        # LIVE; _match_prefix decides how much of them is actually reusable
        h = _chain_hash(0, token_ids[: self.page_size])
        for s in range(self.num_shards):
            if h in self._hash_by_shard[s]:
                return s
        return None

    def least_loaded_shard(self) -> int:
        """Shard with the most allocatable (free + evictable) pages; ties
        break toward the fewest live pages, then the lowest id."""
        return min(range(self.num_shards), key=self.load_key)

    def load_key(self, shard: int):
        """Sort key ordering shards least-loaded first."""
        return (-(self.free_pages_in(shard) + self.evictable_pages_in(shard)),
                self.pages_in_use_in(shard), shard)

    # ----------------------------------------------------- residency match --
    def match_prefix(self, token_ids: Optional[Sequence[int]],
                     num_tokens: int,
                     shard: Optional[int] = None) -> PrefixMatch:
        """Residency-first prefix lookup: the longest leading run of the
        prompt's full pages that exists in ANY tier, per page with its
        ``PageResidency``. Read-only — touches no stats, pins nothing —
        so the scheduler can plan prefetches for still-queued requests
        without skewing hit accounting (``allocate`` does the counting
        when reuse actually happens).

        With ``shard=None`` every shard is walked and the deepest match
        wins (ties toward more DEVICE-resident pages). Gate-trimmed the
        same way as ``allocate``'s device match; never matches the entire
        prompt (at least one token always recomputes)."""
        if not self.enable_prefix_cache or token_ids is None:
            return PrefixMatch(shard=shard if shard is not None else 0)
        shards = [shard] if shard is not None else range(self.num_shards)
        best: Optional[PrefixMatch] = None
        for s in shards:
            m = self._walk_residency(token_ids, num_tokens, s)
            if best is None or ((len(m.pages), m.device_pages)
                                > (len(best.pages), best.device_pages)):
                best = m
        return best

    def _walk_residency(self, token_ids: Sequence[int], num_tokens: int,
                        shard: int) -> PrefixMatch:
        max_match = (num_tokens - 1) // self.page_size   # full pages, < all
        table = self._hash_by_shard[shard]
        pages: List[MatchedPage] = []
        gated = 0
        h = 0
        for i in range(max_match):
            lo = i * self.page_size
            h = _chain_hash(h, token_ids[lo:lo + self.page_size])
            if h in table:
                mp = MatchedPage(i, h, PageResidency.DEVICE, table[h])
            elif h in self._staging and self._staging[h].shard == shard:
                mp = MatchedPage(i, h, PageResidency.IN_FLIGHT,
                                 self._staging[h].page)
            elif h in self._host:
                mp = MatchedPage(i, h, PageResidency.HOST)
            else:
                break
            pages.append(mp)
            if self.prefix_gate is None or self.prefix_gate(h):
                gated = len(pages)
        return PrefixMatch(shard=shard, pages=tuple(pages[:gated]))

    # -------------------------------------------------------------- alloc --
    def _evict_one(self, shard: int, spare_host_sourced: bool = False) -> None:
        lru = self._lru_by_shard[shard]
        # Victim selection: cold end first, but pages a prefetch just landed
        # (``_host_sourced``, not yet consumed by their requester's
        # allocate) are passed over while ANY other evictable page exists —
        # without this grace period the running lanes' page growth steals
        # freshly-prefetched pages before the gated request admits, and the
        # host tier converges to pure churn. Allocation for LIVE work
        # (admission, decode growth) may still take them as a last resort;
        # staging allocation (``spare_host_sourced``) may not — one queued
        # request's prefetch evicting another's landed pages is exactly the
        # churn the grace period exists to stop, and refusing just bounds
        # the prefetch depth to the shard's actual headroom.
        page = next((p for p in lru
                     if self._page_to_hash[p] not in self._host_sourced),
                    None)
        if page is None:
            if spare_host_sourced:
                raise OutOfBlocks(
                    f"shard {shard}: only landed-prefetch pages are "
                    f"evictable; no headroom for more staging", shard)
            # All evictable pages are landed prefetches: steal the HOT end.
            # Commits happen in queue order, so the hot end belongs to the
            # deepest-queued request — farthest from admission, with time
            # to re-prefetch. Stealing the cold end would hit the NEXT
            # request to admit, breaking its chain match and cascading the
            # steal down the whole queue (each broken admission allocates
            # fresh pages and steals its successor's prefix).
            page, _ = lru.popitem(last=True)
        else:
            del lru[page]
        h = self._page_to_hash.pop(page)
        table = self._hash_by_shard[shard]
        if table.get(h) == page:
            del table[h]
            # Hierarchical tier: capture the evicted prefix host-side
            # instead of destroying it — but only when the hash leaves the
            # DEVICE tier entirely (it may survive on another shard) and
            # is not already HOST / IN_FLIGHT.
            if (self.host_tier_enabled and h not in self._host
                    and h not in self._staging
                    and not any(h in t for t in self._hash_by_shard)):
                payload = self.spill_sink(h, page, shard)
                if payload is not None:
                    self._host_insert(h, payload)
                    self.spilled_pages += 1
        self._host_sourced.discard(h)   # an unused prefetched copy died
        self._free_by_shard[shard].append(page)
        self.evictions += 1

    def _host_insert(self, h: int, payload) -> None:
        self._host[h] = payload
        self._host.move_to_end(h)
        while len(self._host) > self.host_pages:         # host LRU: cold end
            self._host.popitem(last=False)
            self.host_evictions += 1

    def _pop_free(self, shard: int, spare_host_sourced: bool = False) -> int:
        """Pop a physical page off the shard's free list, evicting (and
        possibly spilling) the LRU cold end when it is empty."""
        if not self._free_by_shard[shard]:
            if not self._lru_by_shard[shard]:
                raise OutOfBlocks(
                    f"shard {shard} exhausted (free + cached empty)", shard)
            self._evict_one(shard, spare_host_sourced)
        return self._free_by_shard[shard].pop()

    def _take_free(self, shard: int) -> int:
        self.fresh_pages_allocated += 1
        return self._pop_free(shard)

    # ----------------------------------------------------------- prefetch --
    def begin_prefetch(self, h: int, shard: int) -> Tuple[int, Any]:
        """Reserve a staging page on ``shard`` for a host-resident hash and
        transition it HOST -> IN_FLIGHT. Returns (staging page id, host
        payload) — the engine dispatches the actual host->HBM upload.
        Raises ``OutOfBlocks`` when the shard has no page to stage into
        (the request then admits with whatever already landed)."""
        if h not in self._host:
            raise KeyError(f"hash {h} is not host-resident "
                           f"({self.residency(h).value})")
        # may evict/spill; may raise — but never steals a landed prefetch
        page = self._pop_free(shard, spare_host_sourced=True)
        payload = self._host.pop(h)
        self._staging[h] = _Staging(page, shard, payload)
        self.prefetch_begun += 1
        return page, payload

    def commit_prefetch(self, h: int) -> bool:
        """Land an IN_FLIGHT hash: register the staging page in its shard's
        prefix table (parked at the LRU's hot end, refcount 0, evictable —
        exactly like a just-freed registered page). Call only AFTER the
        upload is ordered before any step that could read the page; in this
        engine that is "the next scheduler turn" (dispatch order). Returns
        False when the fetch lost a race — the hash re-registered on device
        meanwhile — in which case the staging page is simply freed."""
        st = self._staging.pop(h, None)
        if st is None:
            return False
        table = self._hash_by_shard[st.shard]
        if h in table or st.page in self._page_to_hash \
                or any(h in t for t in self._hash_by_shard):
            # a concurrent recompute registered the same prefix: keep the
            # device copy, drop ours (each hash lives in ONE tier)
            self._free_by_shard[st.shard].append(st.page)
            self.prefetch_aborted += 1
            return False
        table[h] = st.page
        self._page_to_hash[st.page] = h
        self._lru_by_shard[st.shard][st.page] = None     # hot end
        self._host_sourced.add(h)
        self.prefetch_committed += 1
        return True

    def abort_prefetch(self, h: int) -> bool:
        """Fail an IN_FLIGHT hash (fault injection / engine drain): free
        the staging page and return the payload to the host store so the
        fetch is retriable (IN_FLIGHT -> HOST), unless the hash
        re-registered on device meanwhile (then the payload is dropped to
        keep the tiers disjoint)."""
        st = self._staging.pop(h, None)
        if st is None:
            return False
        self._free_by_shard[st.shard].append(st.page)
        self.prefetch_aborted += 1
        if not any(h in t for t in self._hash_by_shard):
            self._host_insert(h, st.payload)
        return True

    def _match_prefix(self, token_ids: Optional[Sequence[int]],
                      num_tokens: int,
                      shard: int) -> Tuple[List[int], int, int, List[int]]:
        """Leading full-page DEVICE cache hits for this prompt WITHIN
        ``shard``. Returns (hit pages, matched token count, chain hash at
        the match boundary, consumed host-sourced markers). Never matches
        the ENTIRE prompt — at least one token is recomputed so prefill
        emits logits.

        With a ``prefix_gate`` the match is TRIMMED back to the deepest
        boundary the gate accepts (not broken at the first rejection):
        recurrent-state snapshots only exist at chunk-end boundaries, so
        intermediate page hashes are registered but not restorable."""
        if not self.enable_prefix_cache or token_ids is None:
            return [], 0, 0, []
        max_match = (num_tokens - 1) // self.page_size   # full pages, < all
        table = self._hash_by_shard[shard]
        hits: List[int] = []
        hashes: List[int] = []
        gated = 0                      # deepest gate-accepted page count
        h = 0
        for i in range(max_match):
            lo = i * self.page_size
            h = _chain_hash(h, token_ids[lo:lo + self.page_size])
            self.prefix_queries += 1
            page = table.get(h)
            if page is None:
                break
            hits.append(page)
            hashes.append(h)
            if self.prefix_gate is None or self.prefix_gate(h):
                gated = len(hits)
        hits = hits[:gated]
        consumed: List[int] = []
        for hh in hashes[:gated]:      # device-hit vs host-restored split
            if hh in self._host_sourced:
                self._host_sourced.discard(hh)
                consumed.append(hh)
                self.prefix_host_hits += 1
            else:
                self.prefix_device_hits += 1
        self.prefix_hits += len(hits)
        return hits, len(hits) * self.page_size, \
            (hashes[gated - 1] if gated else 0), consumed

    def allocate(self, seq_id: int, num_tokens: int,
                 token_ids: Optional[Sequence[int]] = None,
                 shard: Optional[int] = None) -> Tuple[List[int], int]:
        """Allocate pages for a new sequence of ``num_tokens`` prompt tokens,
        pinned to ``shard`` (default: the least-loaded shard; with one shard
        this is the PR-1 behaviour unchanged).

        ``token_ids`` (when given) enables prefix caching: leading full pages
        whose chain hash is registered ON THIS SHARD are reused (refcount
        bumped, zero fresh pages, zero recompute). Returns
        (pages, cached_token_count).
        """
        assert seq_id not in self._seqs
        if shard is None:
            shard = self.least_loaded_shard()
        need = (num_tokens + self.page_size - 1) // self.page_size
        stats_snap = (self.prefix_queries, self.prefix_hits,
                      self.prefix_device_hits, self.prefix_host_hits)
        hits, cached, h_match, consumed = \
            self._match_prefix(token_ids, num_tokens, shard)
        for p in hits:                                  # commit the reuse
            self._ref[p] = self._ref.get(p, 0) + 1      # may come off the LRU
            self._lru_by_shard[shard].pop(p, None)
        fresh_need = need - len(hits)
        # capacity check AFTER pinning the hits — a hit sitting in the LRU
        # must not be double-counted as evictable capacity
        avail = self.free_pages_in(shard) + self.evictable_pages_in(shard)
        if fresh_need > avail:
            for p in reversed(hits):                    # unwind the pins
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    del self._ref[p]
                    self._lru_by_shard[shard][p] = None  # back to the cache
            # a failed attempt reused nothing: keep the surfaced hit-rate
            # stats clean when the scheduler probes several shards (the
            # host-sourced markers it consumed come back too)
            (self.prefix_queries, self.prefix_hits,
             self.prefix_device_hits, self.prefix_host_hits) = stats_snap
            self._host_sourced.update(consumed)
            raise OutOfBlocks(
                f"shard {shard}: need {fresh_need} fresh pages, "
                f"{self.free_pages_in(shard)}+"
                f"{self.evictable_pages_in(shard)} free+cached", shard)
        pages = list(hits)
        for _ in range(fresh_need):
            p = self._take_free(shard)
            self._ref[p] = 1
            pages.append(p)
        self._seqs[seq_id] = SeqBlocks(pages, num_tokens, cached,
                                       committed_pages=len(hits),
                                       committed_hash=h_match,
                                       shard=shard)
        return pages, cached

    def commit_prefill(self, seq_id: int, computed_tokens: int,
                       token_ids: Optional[Sequence[int]] = None) -> None:
        """Register full prompt pages whose KV is now actually written, so
        later arrivals can prefix-hit them (in the owning shard's table).
        Idempotent per page. Re-registering a hash the host tier still
        holds drops the host copy — a freshly computed device page
        supersedes it (hash lives in ONE tier)."""
        if not self.enable_prefix_cache or token_ids is None:
            return
        sb = self._seqs[seq_id]
        table = self._hash_by_shard[sb.shard]
        full = computed_tokens // self.page_size
        if full <= sb.committed_pages:
            return
        h = sb.committed_hash          # resume the chain: O(new pages) only
        for i in range(sb.committed_pages, full):
            lo = i * self.page_size
            h = _chain_hash(h, token_ids[lo:lo + self.page_size])
            page = sb.pages[i]
            if h not in table and page not in self._page_to_hash:
                table[h] = page
                self._page_to_hash[page] = h
                self._host.pop(h, None)
        sb.committed_pages = full
        sb.committed_hash = h

    def append_token(self, seq_id: int) -> int:
        """Account one generated token; grows the page list on boundary
        (drawing ONLY from the sequence's own shard). Returns the token's
        global flat slot index."""
        sb = self._seqs[seq_id]
        pos = sb.num_tokens
        if pos // self.page_size >= len(sb.pages):
            p = self._take_free(sb.shard)               # may evict; may raise
            self._ref[p] = 1
            sb.pages.append(p)
        sb.num_tokens += 1
        return sb.pages[pos // self.page_size] * self.page_size + \
            pos % self.page_size

    def free(self, seq_id: int) -> None:
        """Drop the sequence's references. Registered pages whose refcount
        hits zero park in their shard's LRU prefix cache; others return to
        the shard free list. Used both for FINISHED requests and for
        preemption."""
        sb = self._seqs.pop(seq_id, None)
        if not sb:
            return
        for p in reversed(sb.pages):
            self._ref[p] -= 1
            if self._ref[p] > 0:
                continue
            del self._ref[p]
            if p in self._page_to_hash:
                self._lru_by_shard[sb.shard][p] = None  # cached, evictable
            else:
                self._free_by_shard[sb.shard].append(p)

    # -------------------------------------------------------------- audit --
    def audit(self) -> List[str]:
        """Invariant auditor: cross-check refcounts, free lists, LRUs, the
        prefix tables AND the host tier against the ground truth (the live
        sequences). Returns human-readable violations (empty = the pool is
        clean) — the chaos suite's oracle after every fault episode,
        O(pages), not for the hot path. Invariants:

          1. every physical page is in EXACTLY one home (``PageHome``):
             its shard's free list, its shard's LRU, referenced by a live
             sequence, or reserved as an IN_FLIGHT staging page;
          2. ``_ref[p]`` equals p's multiplicity across live sequences
             (no leaked or dangling refcounts, none <= 0);
          3. the shard prefix tables and ``_page_to_hash`` are inverse
             bijections; LRU pages are all registered, free and staging
             pages never;
          4. a sequence's pages are duplicate-free, inside its pinned
             shard's range, and exactly ``ceil(num_tokens / page_size)``;
          5. two-tier: host-store hashes are disjoint from every device
             table and from the staging ledger; the store respects its
             ``host_pages`` capacity (empty when the tier is off).
        """
        out: List[str] = []
        ps = self.page_size

        counts: Dict[int, int] = {}            # ground-truth refcounts
        for sid, sb in self._seqs.items():
            lo, hi = self.shard_ranges[sb.shard]
            if len(set(sb.pages)) != len(sb.pages):
                out.append(f"seq {sid}: duplicate page in its page list")
            need = (sb.num_tokens + ps - 1) // ps
            if len(sb.pages) != need:
                out.append(f"seq {sid}: {len(sb.pages)} pages for "
                           f"{sb.num_tokens} tokens (want {need})")
            for p in sb.pages:
                counts[p] = counts.get(p, 0) + 1
                if not lo <= p < hi:
                    out.append(f"seq {sid}: page {p} outside its shard "
                               f"{sb.shard} range [{lo},{hi})")
        if counts != self._ref:
            for p in set(counts) | set(self._ref):
                have, want = self._ref.get(p, 0), counts.get(p, 0)
                if have != want:
                    out.append(f"page {p}: refcount {have}, but "
                               f"{want} live sequence(s) hold it")

        seen: Dict[int, str] = {}              # page -> which home
        for p in self._ref:
            seen[p] = "referenced"
        for h, st in self._staging.items():
            lo, hi = self.shard_ranges[st.shard]
            if not lo <= st.page < hi:
                out.append(f"staging page {st.page} (hash {h}) outside "
                           f"shard {st.shard} range [{lo},{hi})")
            if st.page in seen:
                out.append(f"page {st.page}: staging AND {seen[st.page]}")
            seen[st.page] = "staging"
            if st.page in self._page_to_hash:
                out.append(f"staging page {st.page} is still registered "
                           "in the prefix table")
        for s in range(self.num_shards):
            lo, hi = self.shard_ranges[s]
            for home, pages in (("free", self._free_by_shard[s]),
                                ("lru", self._lru_by_shard[s])):
                for p in pages:
                    if not lo <= p < hi:
                        out.append(f"shard {s} {home} list: page {p} "
                                   f"outside range [{lo},{hi})")
                    if p in seen:
                        out.append(f"page {p}: in shard {s} {home} list "
                                   f"AND {seen[p]}")
                    seen[p] = f"shard {s} {home}"
        missing = set(range(self.num_pages)) - set(seen)
        if missing:
            out.append(f"leaked pages (no free list, LRU, staging slot, "
                       f"or live sequence holds them): {sorted(missing)}")

        # prefix tables <-> _page_to_hash must be inverse bijections
        entries = 0
        for s in range(self.num_shards):
            lo, hi = self.shard_ranges[s]
            for h, p in self._hash_by_shard[s].items():
                entries += 1
                if self._page_to_hash.get(p) != h:
                    out.append(f"shard {s} prefix table: hash {h} -> page "
                               f"{p}, but _page_to_hash says "
                               f"{self._page_to_hash.get(p)}")
                if not lo <= p < hi:
                    out.append(f"shard {s} prefix table: page {p} outside "
                               f"range [{lo},{hi})")
        if entries != len(self._page_to_hash):
            out.append(f"{len(self._page_to_hash)} pages registered but "
                       f"{entries} prefix-table entries")
        for s in range(self.num_shards):
            for p in self._lru_by_shard[s]:
                if p not in self._page_to_hash:
                    out.append(f"shard {s} LRU: page {p} unregistered "
                               "(should be on the free list)")
            for p in self._free_by_shard[s]:
                if p in self._page_to_hash:
                    out.append(f"shard {s} free list: page {p} still "
                               "registered in the prefix table")

        # two-tier invariants (5)
        if self.host_pages <= 0 and self._host:
            out.append(f"host tier disabled but the store holds "
                       f"{len(self._host)} page(s)")
        if self.host_pages > 0 and len(self._host) > self.host_pages:
            out.append(f"host store over capacity: {len(self._host)} > "
                       f"{self.host_pages}")
        for h in self._host:
            if h in self._staging:
                out.append(f"hash {h}: HOST and IN_FLIGHT simultaneously")
            for s in range(self.num_shards):
                if h in self._hash_by_shard[s]:
                    out.append(f"hash {h}: in the host store AND shard "
                               f"{s}'s device table")

        if not self._seqs and self.pages_in_use:
            out.append(f"no live sequences but pages_in_use = "
                       f"{self.pages_in_use}")
        return out

    # ------------------------------------------------------------ mapping --
    def page_table(self, seq_id: int, width: Optional[int] = None) -> np.ndarray:
        """Physical page ids in logical order, padded with -1 to ``width``
        (gather sentinel)."""
        pages = self._seqs[seq_id].pages
        width = width or len(pages)
        out = np.full(width, -1, np.int32)
        out[: len(pages)] = pages[:width]
        return out

    def slot_indices(self, seq_id: int, positions: np.ndarray,
                     skip: Optional[np.ndarray] = None) -> np.ndarray:
        """Map logical positions -> global physical flat slots. ``skip``
        marks the Opt-KV SkipSet (Eq. 5): those slots come back -1."""
        sb = self._seqs[seq_id]
        pages = np.asarray(sb.pages, np.int32)
        page_of = positions // self.page_size
        slots = pages[page_of] * self.page_size + positions % self.page_size
        slots = slots.astype(np.int32)
        if skip is not None:
            slots = np.where(skip, -1, slots)
        return slots

    def fragmentation(self) -> float:
        """Fraction of referenced slots that hold no token (paper Fig. 3).
        Shared pages are counted once — the pooled allocator's whole point."""
        live = {p for s in self._seqs.values() for p in s.pages}
        alloc = len(live) * self.page_size
        used = sum(s.num_tokens for s in self._seqs.values())
        return max(1.0 - used / alloc, 0.0) if alloc else 0.0
