"""KV prefix cache: a chunk-hash trie over a bounded LRU pool (a copy of
``repro.serving.prefix_cache``, which is framework-free).

Identical prompt prefixes (shared system prompts, few-shot preambles)
re-run the full prefill forward in a naive engine.  This cache keys
KV-cache snapshots by a *chain hash* over fixed-size token chunks:

    h_1 = H(chunk_1)        h_2 = H(h_1 || chunk_2)   ...

so a chain hash at depth d commits to the entire token prefix of length
d * chunk — the dict of entries IS a trie over chunk-granular prefixes
(every stored node is addressable by its chain hash; scanning a prompt's
chain hashes deepest-first and stopping at the first HIT yields the
longest cached prefix, so intermediate boundaries never need their own
entries).  Values are cropped KV-cache pytrees (batch=1,
seq capacity == prefix length) that `Engine._write_slot` copies into a
pool slot, skipping the chunk forwards entirely.

Only *full* chunks of the first ``len(prompt) - 1`` tokens are ever
matched or stored: the last prompt token must always be processed by a
real forward so the engine has logits to sample the first output token
from.

The pool is bounded: `capacity` entries, least-recently-used eviction
(both lookups and inserts refresh recency).  Eviction counts are
surfaced so the engine can export `serving.prefix_cache.evictions`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Sequence, Tuple


def chain_hashes(prompt: Sequence[int], chunk: int) -> List[str]:
    """Chain hash per full chunk of prompt[:-1] (see module docstring).

    hashes[d] commits to prompt[0 : (d + 1) * chunk].
    """
    n_full = max(len(prompt) - 1, 0) // chunk
    hs: List[str] = []
    h = hashlib.sha256()
    for d in range(n_full):
        seg = prompt[d * chunk:(d + 1) * chunk]
        # every token is TERMINATED by the delimiter, not just separated:
        # successive h.update calls concatenate, so "1|23" + "4|5" and
        # "1|2" + "34|5" would otherwise hash identical byte streams and
        # match() could hand one prompt another prompt's KV prefix
        h.update(b"".join(str(int(t)).encode() + b"|" for t in seg))
        hs.append(h.hexdigest())
    return hs


@dataclasses.dataclass
class PrefixEntry:
    n_tokens: int          # prefix length covered by this entry
    caches: Any = None     # contiguous layout: batch=1 cache pytree
    pages: Optional[List[int]] = None  # paged layout: ref-held page-id chain


class PrefixCache:
    """Bounded LRU pool of KV prefix snapshots, keyed by chain hash.

    Entries hold either a concrete cropped KV pytree (``caches``, the
    contiguous engine layout) or a ref-counted page-id chain (``pages``,
    the paged layout — the pool refcounts, not this cache, own page
    lifetime; ``on_evict`` is how the engine releases an evicted entry's
    references).  ``on_evict`` fires for *every* eviction — capacity
    overflow in :meth:`insert` and explicit :meth:`evict_lru` alike.
    """

    def __init__(self, chunk: int, capacity: int,
                 on_evict: Optional[Callable[[PrefixEntry], None]] = None):
        assert chunk > 0 and capacity > 0
        self.chunk = chunk
        self.capacity = capacity
        self.on_evict = on_evict
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.hits = 0          # chunks served from cache
        self.misses = 0        # full chunks that had to be computed
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, hkey: str) -> bool:
        return hkey in self._entries

    def match(self, prompt: Sequence[int]
              ) -> Tuple[int, Optional[PrefixEntry], List[str]]:
        """Longest cached prefix of `prompt`.

        Returns (matched_tokens, entry-or-None, chain_hashes) and
        updates hit/miss counters: one hit per matched chunk, one miss
        per remaining full chunk (the ones the engine must now compute).
        """
        hs = chain_hashes(prompt, self.chunk)
        best: Optional[PrefixEntry] = None
        depth = 0
        # deepest-first: hashes[d] commits to the WHOLE prefix up to
        # depth d, so the first hit scanning backwards is the longest
        # cached prefix — one dict probe per depth, no trie walk
        for d in range(len(hs) - 1, -1, -1):
            e = self._entries.get(hs[d])
            if e is not None:
                self._entries.move_to_end(hs[d])
                best, depth = e, d + 1
                break
        self.hits += depth
        self.misses += len(hs) - depth
        return (best.n_tokens if best else 0), best, hs

    def insert(self, hkey: str, caches: Any, n_tokens: int,
               pages: Optional[List[int]] = None) -> int:
        """Store a snapshot; returns the number of evictions performed.
        Re-inserting an existing key only refreshes its recency."""
        if hkey in self._entries:
            self._entries.move_to_end(hkey)
            return 0
        self._entries[hkey] = PrefixEntry(n_tokens=n_tokens, caches=caches,
                                          pages=pages)
        evicted = 0
        while len(self._entries) > self.capacity:
            _, entry = self._entries.popitem(last=False)
            evicted += 1
            if self.on_evict is not None:
                self.on_evict(entry)
        self.evictions += evicted
        return evicted

    def evict_lru(self) -> Optional[PrefixEntry]:
        """Evict the least-recently-used entry (pool-pressure path).

        Returns the evicted entry (after ``on_evict`` ran) or ``None`` if
        the cache is empty.
        """
        if not self._entries:
            return None
        _, entry = self._entries.popitem(last=False)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(entry)
        return entry
