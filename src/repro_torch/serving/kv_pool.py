"""Paged KV cache: fixed-size page pool + block tables with ref-counted,
copy-on-write prefix sharing.  The twin of ``repro.serving.kv_pool``.

The contiguous engine layout gives every slot a private ``[max_len]`` KV
slab; a prefix-cache hit *copies* the cached prefix into the slot.  The
paged layout is the vLLM idea applied to the same engine: KV lives in one
fixed pool of ``n_pages`` pages of ``page_size`` tokens each, and every
slot owns a *block table* — a row of page ids whose concatenation is that
slot's logical ``[max_len]`` sequence.  A prefix-cache hit then pins the
entry's pages into the hitter's table (refcount bump, O(1) per hit); only
a *partial* trailing page is ever copied, and only when someone will
write into it (copy-on-write).

Three layers live here:

- ``PagePool`` — the host-side allocator: LIFO free list + per-page
  refcounts.  ``alloc`` gives pages at refcount 1, ``share`` pins,
  ``release`` unpins and returns pages to the free list at zero.
- ``PagedKV`` — per-slot block tables, the pending-COW map, admission
  math, per-tick write plans, and slot/entry lifecycle.  Pure host
  bookkeeping on numpy; it never touches device memory.  Both classes
  are copies of the JAX package's.
- ``gather_pages`` / ``scatter_pages`` / ``copy_page`` — torch index
  ops on the pool.  Gather builds the contiguous ``[n_slots, max_len]``
  view the model already understands from the pool + a read table (a
  fresh tensor: nothing in it aliases the pool while the forward writes
  it); scatter writes back, in place, only the pages a write plan marked
  dirty.

Device pool leaves are the port's stacked contiguous cache leaves
``[L, n_slots, max_len, ...]`` with the slot axis (1) and the sequence
axis (2) replaced by ``(n_pages + 1, page_size)``; page ``n_pages`` is
the trash page and is never allocated.  The JAX scatter has one static
shape for every tick, so it routes every clean page to the trash page;
eager PyTorch has no such constraint, so the port's scatter indexes only
the dirty pages (whose destinations are distinct, so ``index_copy_`` is
deterministic on CUDA) and never writes the trash page.  After the same
steps the two pools agree on every page but the trash page.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "PagePool",
    "PagedKV",
    "WriteCommit",
    "gather_pages",
    "scatter_pages",
    "copy_page",
    "paged_leaf_shape",
]

SLOT_AXIS = 1   # every pool leaf is [L, n_pages + 1, page_size, ...]


class PagePool:
    """Host-side ref-counted page allocator over a fixed pool.

    Page ids are ``0 .. n_pages - 1``; id ``n_pages`` is reserved as the
    device-side trash page and never handed out.  Every page is either on
    the free list (refcount 0) or owned (refcount >= 1) — ``check()``
    asserts exactly that, and the allocator raises on double-free and on
    releasing below zero rather than silently corrupting state.
    """

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.trash = self.n_pages  # device arrays are sized n_pages + 1
        # Pop from the end -> pages are handed out in ascending id order,
        # which keeps allocation deterministic for the bench gate.
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.refcount = np.zeros(self.n_pages, dtype=np.int32)
        self.total_allocs = 0
        self.total_frees = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages at refcount 1, or ``None`` if the pool can't."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0
            self.refcount[p] = 1
        self.total_allocs += n
        return pages

    def share(self, pages: List[int]) -> None:
        """Pin already-owned pages (one extra reference each)."""
        for p in pages:
            if not (0 <= p < self.n_pages) or self.refcount[p] <= 0:
                raise ValueError(f"share of unowned page {p}")
            self.refcount[p] += 1

    def release(self, pages: List[int]) -> int:
        """Drop one reference per page; returns how many hit zero (freed)."""
        freed = 0
        for p in pages:
            if not (0 <= p < self.n_pages) or self.refcount[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed += 1
                self.total_frees += 1
        return freed

    def check(self, owners: Optional[Dict[int, int]] = None) -> None:
        """Invariant check: free list and refcounts partition the pool.

        With ``owners`` (page id -> expected reference count from a model
        of who holds what), also checks refcounts match the model exactly
        — the property tests drive this.
        """
        free = set(self._free)
        assert len(free) == len(self._free), "free list has duplicates"
        for p in range(self.n_pages):
            rc = int(self.refcount[p])
            assert rc >= 0
            assert (rc == 0) == (p in free), (
                f"page {p}: rc={rc} free={p in free}")
        if owners is not None:
            for p in range(self.n_pages):
                assert int(self.refcount[p]) == owners.get(p, 0), (
                    f"page {p}: rc={int(self.refcount[p])} "
                    f"model={owners.get(p, 0)}"
                )


@dataclass
class WriteCommit:
    """One pending-COW resolution carried from ``write_plan`` to ``commit``."""

    slot: int
    pos: int  # block-table position within the slot
    old_page: int  # the shared page the slot was reading
    new_page: int  # the private copy the scatter just populated


class PagedKV:
    """Block tables + pending-COW bookkeeping for the serving engine.

    Lifecycle per request (all host-side; the engine drives it):

    - ``pages_for``/``fresh_pages_needed`` — admission math.  A request
      admits only if the pool covers its *worst case*
      (``ceil(min(prompt + max_new, max_len) / page_size)`` pages, minus
      full pages pinned from a prefix hit).
    - ``bind`` — build the slot's table: shared full pages go in as-is,
      a shared *partial* page goes in on the read side with a fresh page
      registered in ``pending_cow`` (the first write through that table
      position scatters into the fresh copy), remaining positions get
      fresh pages.  The caller pins shared pages *before* calling.
    - ``write_plan`` — per tick: given ``{slot: (start, end)}`` token
      write ranges, produce the read table, the write table (pending COW
      redirected), the dirty-page mask, and the commits to apply after
      the device step.  Asserts no plain write ever lands on a shared
      page.
    - ``commit`` — after the device scatter: point the table at the COW
      copies, drop the old shared references.
    - ``release_slot`` — request finished: drop every reference the slot
      holds (including unresolved pending-COW pages).
    - ``entry_pages`` — prefix-cache insert: share the slot's full pages
      with the entry; a trailing partial page is copied iff the donor
      will still write inside it, otherwise shared outright.
    """

    def __init__(self, pool: PagePool, n_slots: int, pages_per_slot: int):
        self.pool = pool
        self.n_slots = int(n_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.page_size = pool.page_size
        self.trash = pool.trash
        self.tables = np.full((n_slots, pages_per_slot), self.trash,
                              dtype=np.int32)
        # valid prefix of each row
        self.used = np.zeros(n_slots, dtype=np.int32)
        # (slot, pos) -> fresh page
        self.pending_cow: Dict[Tuple[int, int], int] = {}

    # -- admission math ----------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)  # ceil

    def fresh_pages_needed(self, cap_tokens: int, matched: int) -> int:
        """Pages to allocate for a request: worst case minus shared fulls.

        A shared *partial* page still costs a fresh page (its eager COW
        copy), so only full shared pages reduce the bill.
        """
        return self.pages_for(cap_tokens) - int(matched) // self.page_size

    # -- slot lifecycle ----------------------------------------------------

    def bind(self, slot: int, cap_tokens: int, matched: int,
             shared_pages: List[int]) -> List[int]:
        """Build ``slot``'s block table; returns the fresh pages allocated.

        ``shared_pages`` are the prefix entry's pages covering ``matched``
        tokens, already pinned by the caller.  Raises if the pool cannot
        cover the request — callers check ``fresh_pages_needed`` first.
        """
        need = self.pages_for(cap_tokens)
        assert need <= self.pages_per_slot
        full, part = divmod(int(matched), self.page_size)
        assert len(shared_pages) == full + (1 if part else 0)
        fresh = self.pool.alloc(need - full)
        if fresh is None:
            raise RuntimeError(
                f"pool exhausted binding slot {slot}: need {need - full}, "
                f"free {self.pool.free_pages}")
        row = self.tables[slot]
        row[:] = self.trash
        row[:full] = shared_pages[:full]
        k = 0
        if part:
            row[full] = shared_pages[full]  # read through the shared page…
            self.pending_cow[(slot, full)] = fresh[k]  # …write into the copy
            k += 1
        row[full + (1 if part else 0):need] = fresh[k:]
        self.used[slot] = need
        return fresh

    def release_slot(self, slot: int) -> int:
        """Drop every reference ``slot`` holds; returns pages freed."""
        n = int(self.used[slot])
        pages = [int(p) for p in self.tables[slot, :n]]
        pend_keys = [k for k in self.pending_cow if k[0] == slot]
        pages += [self.pending_cow.pop(k) for k in pend_keys]
        freed = self.pool.release(pages) if pages else 0
        self.tables[slot, :] = self.trash
        self.used[slot] = 0
        return freed

    # -- per-tick write plans ---------------------------------------------

    def write_plan(
        self, writes: Dict[int, Tuple[int, int]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[WriteCommit]]:
        """Plan one device step.

        ``writes`` maps slot -> half-open token range ``[start, end)`` the
        step will write.  Returns ``(read_table, write_table, write_mask,
        commits)``: the gather reads through ``read_table`` (shared pages
        included), the scatter writes only table positions with
        ``write_mask`` set, through ``write_table`` (pending-COW positions
        redirected to their fresh copies — the copy picks up both the
        shared prefix content and the new tokens in the same scatter, so
        a COW split costs exactly one page write and no extra kernel).
        """
        read_tab = self.tables.copy()
        write_tab = self.tables.copy()
        mask = np.zeros((self.n_slots, self.pages_per_slot), dtype=bool)
        commits: List[WriteCommit] = []
        for slot, (start, end) in writes.items():
            if end <= start:
                continue
            assert 0 <= start and end <= self.pages_per_slot * self.page_size
            first = start // self.page_size
            last = (end - 1) // self.page_size
            assert last < int(self.used[slot]), (
                f"slot {slot} writes [{start},{end}) beyond bound pages")
            for pos in range(first, last + 1):
                mask[slot, pos] = True
                fresh = self.pending_cow.get((slot, pos))
                page = int(self.tables[slot, pos])
                if fresh is not None:
                    write_tab[slot, pos] = fresh
                    commits.append(WriteCommit(slot, pos, page, fresh))
                else:
                    # In-place write: the slot must be the page's ONLY
                    # owner.  Shared pages are reachable from a write
                    # range in exactly one way — the partial page of a
                    # prefix hit — and bind() registers that as pending
                    # COW; entry donations only ever cover tokens below
                    # the donor's append-only cursor.  Anything else
                    # here is a refcount bug, not a plan.
                    assert int(self.pool.refcount[page]) == 1, (
                        f"shared page {page} (rc="
                        f"{int(self.pool.refcount[page])}) written in "
                        f"place by slot {slot}")
        return read_tab, write_tab, mask, commits

    def commit(self, commits: List[WriteCommit]) -> None:
        """Apply COW resolutions after the device scatter ran."""
        for c in commits:
            assert self.pending_cow.get((c.slot, c.pos)) == c.new_page
            del self.pending_cow[(c.slot, c.pos)]
            self.tables[c.slot, c.pos] = c.new_page
            self.pool.release([c.old_page])

    # -- prefix-cache entries ---------------------------------------------

    def entry_pages(
        self, slot: int, n_tokens: int, next_write_pos: int,
    ) -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Plan a prefix-cache insert donating ``slot``'s first ``n_tokens``.

        Returns ``(pages, copy, n_stored)``: the page chain the entry
        should hold (references already taken), an optional ``(src, dst)``
        device page copy the caller must perform, and how many tokens the
        chain actually covers.  Full pages are shared outright.  A
        trailing partial page is shared too *unless* the donor will still
        write inside it (``next_write_pos`` inside that page) — then it
        is copied into a fresh page so the donor's future writes don't
        leak into the entry.  If no page is available for that copy the
        entry is truncated to its full pages (``n_stored < n_tokens``).
        """
        full, part = divmod(int(n_tokens), self.page_size)
        row = self.tables[slot]
        assert full + (1 if part else 0) <= int(self.used[slot])
        pages = [int(p) for p in row[:full]]
        self.pool.share(pages)
        copy: Optional[Tuple[int, int]] = None
        n_stored = int(n_tokens)
        if part:
            src = int(row[full])
            if int(next_write_pos) < (full + 1) * self.page_size:
                fresh = self.pool.alloc(1)
                if fresh is None:
                    n_stored = full * self.page_size  # truncate to full pages
                else:
                    copy = (src, fresh[0])
                    # the entry owns the copy (rc already 1)
                    pages.append(fresh[0])
            else:
                self.pool.share([src])
                pages.append(src)
        return (pages, copy, n_stored) if pages else ([], None, 0)

    # -- introspection -----------------------------------------------------

    def referenced_pages(self) -> Dict[int, int]:
        """Reference count per page held by *slots* (tables + pending COW)."""
        refs: Dict[int, int] = {}
        for slot in range(self.n_slots):
            for p in self.tables[slot, : int(self.used[slot])]:
                p = int(p)
                refs[p] = refs.get(p, 0) + 1
        for page in self.pending_cow.values():
            refs[page] = refs.get(page, 0) + 1
        return refs


# -- device-side index ops (called by the engine's paged steps) -----------


def paged_leaf_shape(shape: Tuple[int, ...], ax: int, n_pages: int,
                     page_size: int) -> Tuple[int, ...]:
    """Contiguous cache leaf shape -> pool leaf shape.

    ``ax`` is the slot axis; the sequence axis is ``ax + 1``.  Both are
    replaced by ``(n_pages + 1, page_size)`` — the ``+ 1`` is the trash
    page.
    """
    return shape[:ax] + (n_pages + 1, page_size) + shape[ax + 2:]


def tree_map(fn: Callable, tree: Dict[str, Any], *rest: Dict[str, Any]):
    """Apply `fn` leafwise over nested dicts of tensors (the leaves of
    `tree` and the same keys of each of `rest`)."""
    out = {}
    for k, v in tree.items():
        sub = [r[k] for r in rest]
        out[k] = (tree_map(fn, v, *sub) if isinstance(v, dict)
                  else fn(v, *sub))
    return out


def _leaves(tree: Dict[str, Any]):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _index(idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def gather_pages(pool_tree: Dict[str, Any], table, n_slots: int,
                 pages_per_slot: int, page_size: int) -> Dict[str, Any]:
    """Build the contiguous ``[n_slots, max_len]`` view from the pool.

    ``table`` is the host ``[n_slots, pages_per_slot]`` read table.  For
    each leaf, ``index_select`` along the page axis followed by a
    row-major reshape concatenates each slot's pages in order: exactly
    the view the model's attention already indexes with ``len`` masks.
    The view is a new tensor.
    """
    leaf0 = next(_leaves(pool_tree))
    flat = _index(np.asarray(table).reshape(-1), leaf0.device)

    def g(leaf):
        out = leaf.index_select(SLOT_AXIS, flat)
        return out.reshape(leaf.shape[:SLOT_AXIS]
                           + (n_slots, pages_per_slot * page_size)
                           + leaf.shape[SLOT_AXIS + 2:])

    return tree_map(g, pool_tree)


def scatter_pages(pool_tree: Dict[str, Any], view_tree: Dict[str, Any],
                  write_table, write_mask, n_slots: int,
                  pages_per_slot: int, page_size: int) -> Dict[str, Any]:
    """Write the dirty pages of a contiguous view back into the pool, in
    place, and return the pool.

    Only table positions with ``write_mask`` set are copied, each to its
    ``write_table`` page (pending-COW positions already redirected to
    their fresh copies by the write plan), so shared pages are
    unreachable from the write path.  The destinations are distinct
    (a page has one writer), so the copy has no repeated index.
    """
    mask = np.asarray(write_mask).reshape(-1)
    src = np.flatnonzero(mask)
    if not src.size:
        return pool_tree
    dst = np.asarray(write_table).reshape(-1)[src]
    if len(set(dst.tolist())) != len(dst):
        raise ValueError(f"scatter to a repeated page: {dst.tolist()}")
    leaf0 = next(_leaves(pool_tree))
    src_t, dst_t = _index(src, leaf0.device), _index(dst, leaf0.device)

    def s(pool_leaf, view_leaf):
        v = view_leaf.reshape(view_leaf.shape[:SLOT_AXIS]
                              + (n_slots * pages_per_slot, page_size)
                              + view_leaf.shape[SLOT_AXIS + 2:])
        pool_leaf.index_copy_(SLOT_AXIS, dst_t,
                              v.index_select(SLOT_AXIS, src_t)
                              .to(pool_leaf.dtype))
        return pool_leaf

    return tree_map(s, pool_tree, view_tree)


def copy_page(pool_tree: Dict[str, Any], src: int,
              dst: int) -> Dict[str, Any]:
    """Copy one page (``src -> dst``) across every pool leaf, in place,
    and return the pool."""
    assert src != dst

    def cp(leaf):
        leaf[:, dst].copy_(leaf[:, src])
        return leaf

    return tree_map(cp, pool_tree)
