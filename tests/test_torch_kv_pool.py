"""The port's paged KV pool against the JAX package's.

The host allocator (``PagePool``, ``PagedKV``) is driven through both
packages in lockstep by the seeded random interleavings of
tests/test_kv_pool.py: every call goes to both, their results must be
equal, and after every operation the tables, refcounts, free lists,
pending copy-on-write maps and the ownership model must agree.  The
device ops (``gather_pages``, ``scatter_pages``, ``copy_page``) must
give the JAX package's values on the same seeded pool; the port's
scatter writes only dirty pages, so the pools agree on every page but
the trash page."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import kv_pool as jkv  # noqa: E402
from repro_torch.serving import kv_pool as tkv  # noqa: E402


def _same(a, b) -> bool:
    """Structural equality across the two packages' return values."""
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__
                and dataclasses.astuple(a) == dataclasses.astuple(b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


class Lockstep:
    """Forward every attribute read and call to the JAX object `a` and
    the port's `b`; results (or raised exception types) must match."""

    def __init__(self, a, b):
        self._a, self._b = a, b

    def __getattr__(self, name):
        fa, fb = getattr(self._a, name), getattr(self._b, name)
        if not callable(fa):
            assert _same(fa, fb), (name, fa, fb)
            return fa

        def call(*args, **kw):
            try:
                ra = fa(*args, **kw)
            except Exception as ea:
                with pytest.raises(type(ea)):
                    fb(*args, **kw)
                raise
            rb = fb(*args, **kw)
            assert _same(ra, rb), (name, args, ra, rb)
            return ra
        return call


def _state_equal(pools, kvs):
    (jp, tp), (jk, tk) = pools, kvs
    assert np.array_equal(jp.refcount, tp.refcount)
    assert jp._free == tp._free
    assert (jp.total_allocs, jp.total_frees) == (tp.total_allocs,
                                                 tp.total_frees)
    assert np.array_equal(jk.tables, tk.tables)
    assert np.array_equal(jk.used, tk.used)
    assert jk.pending_cow == tk.pending_cow


# ---------------------------------------------------------------------------
# allocator unit behaviour, both packages
# ---------------------------------------------------------------------------

def _both(n_pages, page_size, n_slots=None, pps=None):
    jp, tp = jkv.PagePool(n_pages, page_size), tkv.PagePool(n_pages,
                                                            page_size)
    pool = Lockstep(jp, tp)
    if n_slots is None:
        return pool, (jp, tp)
    jk, tk = jkv.PagedKV(jp, n_slots, pps), tkv.PagedKV(tp, n_slots, pps)
    return pool, Lockstep(jk, tk), (jp, tp), (jk, tk)


def test_pool_roundtrip_overcommit_and_double_free_in_lockstep():
    pool, raw = _both(4, 8)
    pages = pool.alloc(3)
    pool.share(pages[:2])
    assert pool.release(pages) == 1
    assert pool.release(pages[:2]) == 2
    assert pool.alloc(5) is None and pool.free_pages == 4
    (p,) = pool.alloc(1)
    pool.release([p])
    with pytest.raises(ValueError):
        pool.release([p])
    with pytest.raises(ValueError):
        pool.share([1])
    pool.check()
    assert raw[0]._free == raw[1]._free
    assert np.array_equal(raw[0].refcount, raw[1].refcount)


def test_write_plan_rejects_shared_page_write_in_both():
    """A plan that would write a page with refcount > 1 in place (no
    pending COW) must refuse, in both packages."""
    pool, kv, pools, kvs = _both(8, 4, n_slots=2, pps=4)
    kv.bind(0, 8, 0, [])
    pool.share([int(kvs[0].tables[0, 0])])
    with pytest.raises(AssertionError):
        kv.write_plan({0: (0, 4)})
    _state_equal(pools, kvs)


# ---------------------------------------------------------------------------
# property test: random interleavings in lockstep vs an ownership model
# ---------------------------------------------------------------------------

N_PAGES, PAGE, SLOTS, PPS = 24, 4, 3, 6


class _Model:
    """Who holds which page: per-slot holdings (table + pending COW) and
    per-entry chains (tests/test_kv_pool.py's model)."""

    def __init__(self):
        self.slots = {}
        self.entries = []

    def slot_refs(self):
        refs = {}
        for st in self.slots.values():
            for p in list(st["pages"]) + list(st["pending"].values()):
                refs[p] = refs.get(p, 0) + 1
        return refs

    def owners(self):
        refs = self.slot_refs()
        for chain in self.entries:
            for p in chain:
                refs[p] = refs.get(p, 0) + 1
        return refs


def _bind(rng, pool, kv, model):
    free_slots = [s for s in range(SLOTS) if s not in model.slots]
    if not free_slots:
        return
    slot = int(rng.choice(free_slots))
    matched, shared = 0, []
    if model.entries and rng.random() < 0.6:
        chain = model.entries[int(rng.integers(len(model.entries)))]
        if chain:
            full_tokens = len(chain) * PAGE
            matched = int(full_tokens if rng.random() < 0.5
                          else full_tokens - rng.integers(1, PAGE))
            shared = list(chain)
    cap = (int(rng.integers(matched + 1, PPS * PAGE + 1))
           if matched < PPS * PAGE else matched)
    if pool.free_pages < kv.fresh_pages_needed(cap, matched):
        return
    if shared:
        pool.share(shared)
    fresh = kv.bind(slot, cap, matched, shared)
    full, part = divmod(matched, PAGE)
    row, pending = shared[:full], {}
    if part:
        row.append(shared[full])
        pending[full] = fresh[0]
        row += fresh[1:]
    else:
        row += fresh
    model.slots[slot] = {"pages": row, "pending": pending, "cap": cap,
                         "cursor": matched}


def _write(rng, pool, kv, model):
    cands = [s for s, st in model.slots.items() if st["cursor"] < st["cap"]]
    if not cands:
        return
    slot = int(rng.choice(cands))
    st = model.slots[slot]
    n = int(rng.integers(1, min(st["cap"] - st["cursor"], 2 * PAGE) + 1))
    shared = {p for p, k in model.owners().items() if k >= 2}
    _, wtab, mask, commits = kv.write_plan(
        {slot: (st["cursor"], st["cursor"] + n)})
    assert not {int(p) for p in wtab[mask]} & shared
    kv.commit(commits)
    for c in commits:
        st["pages"][c.pos] = c.new_page
        del st["pending"][c.pos]
    st["cursor"] += n


def _insert_entry(rng, pool, kv, model):
    cands = [s for s, st in model.slots.items() if st["cursor"] >= 1]
    if not cands or len(model.entries) >= 6:
        return
    slot = int(rng.choice(cands))
    st = model.slots[slot]
    n = int(rng.integers(1, st["cursor"] + 1))
    pages, copy, n_stored = kv.entry_pages(slot, n,
                                           next_write_pos=st["cursor"])
    if pages:
        assert n_stored <= n and (copy is None or copy[1] == pages[-1])
        model.entries.append(list(pages))


def _evict_entry(rng, pool, kv, model):
    if model.entries:
        pool.release(model.entries.pop(int(rng.integers(
            len(model.entries)))))


def _release_slot(rng, pool, kv, model):
    if model.slots:
        slot = int(rng.choice(list(model.slots)))
        kv.release_slot(slot)
        del model.slots[slot]


@pytest.mark.parametrize("seed", range(12))
def test_allocator_lockstep_random_interleavings(seed):
    ops = [_bind, _write, _write, _insert_entry, _evict_entry,
           _release_slot]
    rng = np.random.default_rng(seed)
    pool, kv, pools, kvs = _both(N_PAGES, PAGE, n_slots=SLOTS, pps=PPS)
    model = _Model()
    for _ in range(120):
        ops[int(rng.integers(len(ops)))](rng, pool, kv, model)
        _state_equal(pools, kvs)
        pool.check(model.owners())
        assert kv.referenced_pages() == model.slot_refs()
    for slot in list(model.slots):
        kv.release_slot(slot)
    for chain in model.entries:
        pool.release(chain)
    pool.check({})
    _state_equal(pools, kvs)
    assert pool.free_pages == N_PAGES
    assert pools[1].total_allocs == pools[1].total_frees


def test_entry_pages_copy_and_truncation_in_lockstep():
    pool, kv, pools, kvs = _both(16, 4, n_slots=1, pps=4)
    kv.bind(0, 16, 0, [])
    pages, copy, n = kv.entry_pages(0, 6, next_write_pos=6)
    assert copy is not None and n == 6
    pages2, copy2, _ = kv.entry_pages(0, 6, next_write_pos=8)
    assert copy2 is None
    pool.release(pages)
    pool.release(pages2)
    assert kv.release_slot(0) == 4
    _state_equal(pools, kvs)
    pool, kv, pools, kvs = _both(4, 4, n_slots=1, pps=4)
    kv.bind(0, 16, 0, [])
    assert kv.entry_pages(0, 6, next_write_pos=6)[1:] == (None, 4)
    _state_equal(pools, kvs)


# ---------------------------------------------------------------------------
# device ops: values equal to the JAX package's
# ---------------------------------------------------------------------------

N_SLOTS, PPS_D, PS, N_PAGES_D = 2, 3, 4, 7
TABLE = np.array([[5, 0, 2], [1, 6, 3]], np.int32)


def _pool_np(seed=0):
    """A [layers, n_pages + 1, page_size, heads, dim] leaf per name, in
    the port's two-stage tree shape."""
    rng = np.random.default_rng(seed)
    shape = tkv.paged_leaf_shape((2, N_SLOTS, PPS_D * PS, 3, 8), 1,
                                 N_PAGES_D, PS)
    assert shape == jkv.paged_leaf_shape((2, N_SLOTS, PPS_D * PS, 3, 8), 1,
                                         N_PAGES_D, PS)
    return {st: {k: rng.standard_normal(shape).astype(np.float32)
                 for k in ("k", "v")} for st in ("stage0", "stage1")}


def _jax(tree):
    return {st: {k: jnp.asarray(v) for k, v in d.items()}
            for st, d in tree.items()}


def _torch(tree):
    return {st: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for st, d in tree.items()}


AX = {st: {"k": 1, "v": 1} for st in ("stage0", "stage1")}


def test_gather_pages_matches_jax():
    pool = _pool_np()
    want = jkv.gather_pages(_jax(pool), AX, jnp.asarray(TABLE), N_SLOTS,
                            PPS_D, PS)
    got = tkv.gather_pages(_torch(pool), TABLE, N_SLOTS, PPS_D, PS)
    for st in pool:
        for k in ("k", "v"):
            assert got[st][k].shape == (2, N_SLOTS, PPS_D * PS, 3, 8)
            np.testing.assert_array_equal(got[st][k].numpy(),
                                          np.asarray(want[st][k]))


@pytest.mark.parametrize("dirty", [[(0, 1), (1, 2)], [(0, 0), (0, 1),
                                                      (0, 2)], []])
def test_scatter_pages_matches_jax_but_the_trash_page(dirty):
    pool = _pool_np()
    view = _pool_np(seed=1)
    view = {st: {k: v[:, :N_SLOTS * PPS_D].reshape(
        2, N_SLOTS, PPS_D * PS, 3, 8) for k, v in d.items()}
        for st, d in view.items()}
    mask = np.zeros((N_SLOTS, PPS_D), bool)
    for s, p in dirty:
        mask[s, p] = True
    want = jkv.scatter_pages(_jax(pool), AX, _jax(view), jnp.asarray(TABLE),
                             jnp.asarray(mask), N_SLOTS, PPS_D, PS,
                             trash=N_PAGES_D)
    tpool = _torch(pool)
    got = tkv.scatter_pages(tpool, _torch(view), TABLE, mask, N_SLOTS,
                            PPS_D, PS)
    for st in pool:
        for k in ("k", "v"):
            assert got[st][k] is tpool[st][k]          # in place
            g, w = got[st][k].numpy(), np.asarray(want[st][k])
            np.testing.assert_array_equal(g[:, :N_PAGES_D],
                                          w[:, :N_PAGES_D])
            # the port never writes the trash page
            np.testing.assert_array_equal(g[:, N_PAGES_D],
                                          pool[st][k][:, N_PAGES_D])


def test_scatter_refuses_a_repeated_destination():
    pool = _torch(_pool_np())
    view = tkv.gather_pages(pool, TABLE, N_SLOTS, PPS_D, PS)
    table = TABLE.copy()
    table[1, 0] = table[0, 0]
    with pytest.raises(ValueError, match="repeated page"):
        tkv.scatter_pages(pool, view, table, np.ones_like(table, bool),
                          N_SLOTS, PPS_D, PS)


def test_copy_page_matches_jax():
    pool = _pool_np()
    want = jkv.copy_page(_jax(pool), AX, jnp.int32(2), jnp.int32(4))
    got = tkv.copy_page(_torch(pool), 2, 4)
    for st in pool:
        for k in ("k", "v"):
            np.testing.assert_array_equal(got[st][k].numpy(),
                                          np.asarray(want[st][k]))
