"""Serving engine: continuous batching over a slotted KV-cache pool.  The
twin of ``repro.serving.engine``.

Decode: one step over the whole pool; the RequestScheduler (the Vortex
4-mask warp scheduler over request slots) decides which slots advance
each tick.  Every slot computes (a lane mask, as a thread mask
predicates lanes), but only the selected slots' KV caches are written:
the model writes the pool IN PLACE for the slot ids in ``rows``, so the
unselected slots stay bit-identical.  That is the JAX engine's masked
merge (``_masked_merge``) without a second copy of the pool.

Prefill is chunked and batched (``prefill_mode="chunked"``): prompts
stream into the pool's caches in fixed-size chunks, every stalled slot
advancing in one batched call, and a chunk-hash prefix cache
(``prefix_cache.py``) copies cached KV prefixes into slots instead of
recomputing them.  ``prefill_mode="legacy"`` runs one [1, bucket]
prefill per request through the flash-attention kernel and copies the
result into the slot.  The hybrid family (zamba2) has recurrent state
and takes the legacy path only; as in the JAX engine, its pad tokens
run through the SSM and conv states (a fault of the reference that the
port keeps, so both engines give the same tokens).

KV layout (``kv_layout=``): "contiguous" gives every slot a private
[max_len] slab; "paged" (``kv_pool.py``) keeps KV in a fixed pool of
fixed-size pages addressed through per-slot block tables.  Prefix hits
PIN shared pages (refcount bump) instead of copying, only the last
partial page of a shared prefix is ever copied (copy-on-write), and
admission requires the pool to cover a request's worst case.  The paged
steps gather the contiguous view from the pool, run the unchanged model
forward on it, and scatter back only the dirty pages, so greedy decode
gives the same tokens in both layouts.  Only caches whose every leaf has
a [max_len] sequence axis can page: zamba2's SSM and conv states cannot,
and its engine refuses ``kv_layout="paged"`` as the JAX engine does.

Failure semantics: per-request deadlines (finish reason "timeout"), a
bounded admission queue with a shed policy ("shed"), a NaN/Inf logit
guard that degrades to greedy sampling ("degraded"), and a watchdog
around `step()` that retries transient failures with capped exponential
backoff.  All hooks accept an optional `repro_torch.faults.FaultInjector`
and are no-ops when no fault fires: an injected logit fault replaces the
logits only on a tick whose fault code is non-zero, so fault-free
serving launches the same kernels and gives the same tokens as serving
without an injector.

Observability: flight-recorder events (``serving.admit``,
``serving.first_token``, ``serving.finish``, ``kv.oom``, ``kv.cow``,
``kv.evict``, the watchdog's), tracer spans and per-request Perfetto
tracks (pid ``_REQ_TRACK_PID``, one tid per request), the `liveness`
beat that ``/healthz`` reads and `debug_requests()`, at the same points
as the JAX engine; all off unless enabled.  The JAX engine's
``serving.recompiles.*`` counters read its jit cache; PyTorch runs
eagerly and this engine has none.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.faults.plan import FaultInjector, TransientFault
from repro_torch.models import api
from repro_torch.models.params import Model
from repro_torch.obs.flight import flight
from repro_torch.serving import kv_pool
from repro_torch.serving.kv_pool import PagedKV, PagePool
from repro_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from repro_torch.serving.sampler import (SamplerConfig, logit_entropy,
                                         sample_guarded)
from repro_torch.serving.scheduler import RequestScheduler

# Perfetto pid for request-scoped timeline tracks: each rid gets its own
# tid under this pid, so traces show one row per request (admission ->
# queue wait -> prefill chunks -> decode -> finish)
_REQ_TRACK_PID = 1


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    # "eos" | "max_new" | "max_len" | "timeout" | "shed" | "degraded"
    finish_reason: str = ""
    submit_t: float = 0.0
    admit_t: float = 0.0
    first_tok_t: float = 0.0
    last_tok_t: float = 0.0
    deadline_s: Optional[float] = None   # TTL from submit; None = no deadline
    degraded: bool = False               # sampled through the NaN/Inf guard


class Engine:
    def __init__(self, cfg: ModelConfig, params: Model, *,
                 n_slots: int = 8, max_len: int = 512,
                 prompt_bucket: int = 64,
                 decode_width: Optional[int] = None,
                 sampler: SamplerConfig = SamplerConfig(),
                 eos_id: int = 1,
                 prefill_chunk: int = 32,
                 prefill_mode: str = "auto",
                 prefix_cache_entries: int = 32,
                 kv_layout: str = "contiguous",
                 kv_page_size: int = 32,
                 kv_pages: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new",
                 default_deadline_s: Optional[float] = None,
                 step_retries: int = 3,
                 retry_base_s: float = 0.01,
                 retry_max_s: float = 0.25,
                 tick_budget_s: Optional[float] = None):
        """The device is the params' device.  prefill_mode: 'chunked' |
        'legacy' | 'auto' (chunked when the family supports chunk-append
        cache writes and the cache is not a ring).  prefix_cache_entries
        bounds the LRU pool of KV prefix snapshots; 0 disables it.

        kv_layout: 'contiguous' (every slot owns a private [max_len] KV
        slab) or 'paged' (KV lives in a pool of `kv_pages` pages of
        `kv_page_size` tokens; slots hold block tables; prefix hits pin
        shared pages, with copy-on-write on the last partial page).
        Paged needs chunked prefill and max_len % kv_page_size == 0.  The
        default pool gives every slot its worst case plus one page, so
        admission never deadlocks; smaller pools admit a request only
        when the pool covers its worst case, evicting LRU prefix entries
        under pressure.

        Failure semantics: `faults` is an optional FaultInjector.
        `max_queue` bounds the admission queue: a submit beyond it is
        SHED per `shed_policy` ("reject-new" or "drop-oldest").
        Requests past their TTL (`default_deadline_s` when submitted
        without one) finish with reason "timeout".  Transient step
        failures retry up to `step_retries` times with capped
        exponential backoff (`retry_base_s` doubling, capped at
        `retry_max_s`) before re-raising.  Ticks slower than
        `tick_budget_s` bump serving.watchdog.slow_ticks.

        The xlstm, audio and vlm families raise ``NotImplementedError``:
        the JAX engine runs none of them (xlstm's caches hold no "len",
        and the others' prefill needs the stub frontend's frames or
        patches); ``models.api.forward`` drives them."""
        if cfg.family in ("xlstm", "audio", "vlm"):
            raise NotImplementedError(
                f"the serving engine does not run family {cfg.family!r}, "
                "as the JAX engine does not; use models.api.forward")
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.bucket = prompt_bucket
        self.decode_width = decode_width or n_slots
        self.sampler = sampler
        self.eos_id = eos_id
        self.sched = RequestScheduler(n_slots)
        self.requests: Dict[int, Request] = {}
        self.pending: Deque[Request] = deque()
        self._slot_req: Dict[int, Request] = {}
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            sampler.seed)
        self.metrics = obs.Registry()
        self._t_start = time.perf_counter()
        # watchdog-tick liveness: beaten at the top of every step()
        # attempt; the HTTP plane's /healthz derives health from it
        self.liveness = obs.Liveness()
        self.faults = faults
        self.max_queue = max_queue
        if shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        self.shed_policy = shed_policy
        self.default_deadline_s = default_deadline_s
        self.step_retries = step_retries
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.tick_budget_s = tick_budget_s
        self._any_deadlines = False

        if prefill_mode == "auto":
            ring = (cfg.sliding_window is not None
                    and cfg.sliding_window < max_len)
            prefill_mode = ("chunked" if api.supports_chunked_prefill(cfg)
                            and not ring else "legacy")
        if prefill_mode not in ("chunked", "legacy"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.prefill_mode = prefill_mode
        self.chunk = prefill_chunk
        if prefill_mode == "chunked" and max_len % prefill_chunk:
            raise ValueError(
                "max_len must be a multiple of prefill_chunk (chunk writes "
                "must never cross the cache capacity boundary)")
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(prefill_chunk, prefix_cache_entries)
            if prefill_mode == "chunked" and prefix_cache_entries > 0
            else None)
        # per-slot prefill cursor (# prompt tokens already in the cache)
        # and the prompt's chunk-hash chain, kept while the slot prefills
        self._prefill_pos: Dict[int, int] = {}
        self._chunk_hashes: Dict[int, List[str]] = {}
        self._last_oom_rid = -1

        # the pool: a tree of stacked [L, n_slots, ...] leaves (k/v
        # [L, n_slots, max_len, KV, D]; a hybrid model's SSM and conv
        # states have no sequence axis); the host `self.lens` is
        # authoritative and is copied into the pool's per-slot `len`
        # (or the paged view's) before every device step
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.kv_layout = kv_layout
        self._kv: Optional[PagedKV] = None
        if kv_layout == "paged":
            self.caches = self._init_page_pool(kv_page_size, kv_pages)
        else:
            self.caches = api.init_caches(cfg, n_slots, max_len,
                                          device=self.device)
        self.lens = np.zeros(n_slots, np.int32)
        self.last_tok = np.zeros(n_slots, np.int32)

    def _init_page_pool(self, page_size: int,
                        n_pages: Optional[int]) -> Dict[str, Any]:
        """The paged layout's host tables and device pool: every cache
        leaf [L, slot, seq=max_len, ...] becomes [L, n_pages + 1 (trash),
        page_size, ...]; `len` is not a pool leaf (the host `self.lens`
        goes into each step's gathered view instead)."""
        if self.prefill_mode != "chunked":
            raise ValueError(
                "paged KV requires chunked prefill (the legacy bucketed "
                "path writes whole [1, bucket] slabs, not pages)")
        if page_size <= 0 or self.max_len % page_size:
            raise ValueError("max_len must be a multiple of kv_page_size "
                             "(block tables cover whole pages)")
        pps = self.max_len // page_size
        if n_pages is None:
            # worst case for every slot plus one page of headroom each:
            # admission can always succeed once prefix entries are
            # evicted, so paged scheduling never diverges from contiguous
            n_pages = self.n_slots * (pps + 1)
        self._kv = PagedKV(PagePool(n_pages, page_size), self.n_slots, pps)
        spec = api.init_caches(self.cfg, 1, self.max_len, device=self.device)
        spec.pop("len")

        def mk(leaf):
            if leaf.dim() < 3 or leaf.shape[2] != self.max_len:
                raise ValueError(
                    "kv_layout='paged' needs every cache leaf laid out "
                    f"[L, slot, seq={self.max_len}, ..]; got "
                    f"{tuple(leaf.shape)} — use contiguous")
            return torch.zeros(kv_pool.paged_leaf_shape(
                tuple(leaf.shape), 1, n_pages, page_size), dtype=leaf.dtype,
                device=self.device)

        pool = kv_pool.tree_map(mk, spec)
        if self.prefix is not None:
            # paged entries hold ref-counted page chains; eviction (LRU
            # overflow or pool pressure) releases them here
            self.prefix.on_evict = self._on_prefix_evict
        return pool

    # ------------------------------------------------------------- device

    def _sync_len(self) -> None:
        self.caches["len"] = torch.as_tensor(self.lens, device=self.device)

    def _rows(self, sel: np.ndarray) -> torch.Tensor:
        """Slot ids whose caches a step may write (no device sync)."""
        return torch.as_tensor(np.flatnonzero(sel), device=self.device)

    def _prefill_one(self, tokens: np.ndarray, true_len: int):
        """Legacy bucketed prefill: tokens [1, bucket] (padded); returns
        (next_token [1], caches [L,1,bucket,...], bad [1])."""
        logits, _aux, caches = api.forward(
            self.params, {"tokens": torch.as_tensor(tokens)}, self.cfg,
            mode="prefill")
        last = logits[:, true_len - 1]
        tok, bad = sample_guarded(last, self.cfg.vocab_size, self.sampler,
                                  self._gen)
        return tok, caches, bad

    def _forward(self, tokens: torch.Tensor, mode: str, sel: np.ndarray,
                 plan=None) -> torch.Tensor:
        """A chunk or decode forward over the WHOLE pool; only the slots
        in `sel` write their caches.  Contiguous: the model writes the
        pool in place.  Paged (`plan` = the write plan's read table,
        write table and dirty mask): the forward runs on the contiguous
        view gathered through the read table, and only the dirty pages
        go back into the pool."""
        if plan is None:
            self._sync_len()
            caches = self.caches
        else:
            kv = self._kv
            caches = kv_pool.gather_pages(self.caches, plan[0],
                                          self.n_slots, kv.pages_per_slot,
                                          kv.page_size)
            caches["len"] = torch.as_tensor(self.lens, device=self.device)
        logits, _aux, _ = api.forward(self.params, {"tokens": tokens},
                                      self.cfg, mode=mode, caches=caches,
                                      rows=self._rows(sel))
        if plan is not None:
            caches.pop("len")
            kv_pool.scatter_pages(self.caches, caches, plan[1], plan[2],
                                  self.n_slots, kv.pages_per_slot,
                                  kv.page_size)
        return logits

    def _prefill_chunk_step(self, tokens: np.ndarray, last_idx: np.ndarray,
                            sel: np.ndarray, plan=None):
        """Batched chunk prefill: tokens [n_slots, chunk]; last_idx
        [n_slots] indexes each finishing slot's last prompt token."""
        logits = self._forward(torch.as_tensor(tokens), "chunk", sel, plan)
        rows = torch.arange(self.n_slots, device=self.device)
        last = logits[rows, torch.as_tensor(last_idx, device=self.device)
                      .long()]
        return sample_guarded(last, self.cfg.vocab_size, self.sampler,
                              self._gen)

    @staticmethod
    def _apply_logit_fault(last: torch.Tensor,
                           fault_code: int) -> torch.Tensor:
        """Injected logit fault: 0 = identity (no op is launched, so
        fault-free serving is unchanged), 1 = all-NaN, 2 = all-Inf."""
        if not fault_code:
            return last
        return torch.full_like(last, float("nan") if fault_code == 1
                               else float("inf"))

    def _decode_step(self, tokens: np.ndarray, sel: np.ndarray,
                     fault_code: int = 0, plan=None):
        logits = self._forward(torch.as_tensor(tokens)[:, None], "decode",
                               sel, plan)
        last = self._apply_logit_fault(logits[:, -1], fault_code)
        # NaN/Inf guard: rows with any non-finite logit fall back to
        # greedy over sanitized logits instead of emitting garbage
        tok, bad = sample_guarded(last, self.cfg.vocab_size, self.sampler,
                                  self._gen)
        ent = logit_entropy(last, self.cfg.vocab_size).mean()
        return tok, bad, ent

    # ------------------------------------------------------------- requests

    def submit(self, prompt: Sequence[int], max_new: int = 32,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request.  `deadline_s` is a TTL from now (falls back
        to `default_deadline_s`); when the bounded queue is full the
        shed policy finishes a request at once with reason "shed"."""
        prompt = list(prompt)
        if not prompt or len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length must be in [1, {self.max_len - 1}]")
        if self._kv is not None:
            cap = min(len(prompt) + max_new, self.max_len)
            need = self._kv.pages_for(cap)
            if need > self._kv.pool.n_pages:
                raise ValueError(
                    f"request worst case ({need} pages of "
                    f"{self._kv.page_size}) exceeds the pool "
                    f"({self._kv.pool.n_pages} pages) — it could never "
                    "admit")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      submit_t=time.perf_counter(),
                      deadline_s=(deadline_s if deadline_s is not None
                                  else self.default_deadline_s))
        self.requests[rid] = req
        if req.deadline_s is not None:
            self._any_deadlines = True
        self.metrics.counter("serving.requests_submitted").inc()
        if (self.max_queue is not None
                and len(self.pending) >= self.max_queue):
            if self.shed_policy == "drop-oldest":
                self._finish(self.pending.popleft(), "shed")
                self.pending.append(req)
            else:                               # reject-new
                self._finish(req, "shed")
            return rid
        self.pending.append(req)
        return rid

    # -------------------------------------------------------- cache surgery

    # Every pool leaf but `len` has its slot on axis 1, behind the
    # stacked-layer axis.  Only the k/v leaves have a sequence axis (2):
    # it is cropped or zero-filled; recurrent leaves (ssm, conv_*) are
    # copied whole.

    def _pool_leaves(self, tree: Dict[str, Any], src: Dict[str, Any]):
        """(name, pool leaf, source leaf) for every leaf of `src`."""
        for name, sub in src.items():
            if name == "len":
                continue
            if isinstance(sub, dict):
                yield from self._pool_leaves(tree[name], sub)
            else:
                yield name, tree[name], sub

    def _write_slot(self, slot: int, one_caches: Dict[str, Any],
                    prompt_len: int) -> None:
        """Copy a prefilled batch=1 cache into pool slot `slot` (k/v at
        offset 0, cropped to the pool's capacity: max_len, or the window
        of a ring cache, whose first `window` positions are kept as the
        JAX engine's crop keeps them); positions past it keep their
        contents, masked by the slot's len and overwritten by decode."""
        for name, pool, src in self._pool_leaves(self.caches, one_caches):
            if name in ("k", "v"):
                n = min(src.shape[2], pool.shape[2])
                pool[:, slot, :n] = src[:, 0, :n].to(pool.dtype)
            else:
                pool[:, slot] = src[:, 0].to(pool.dtype)
        self.lens[slot] = prompt_len

    def _write_slots_masked(self, one_caches: Dict[str, Any],
                            sel: np.ndarray) -> None:
        """Broadcast ONE batch=1 prefix snapshot into every slot in
        `sel`: the snapshot (k/v zero-padded to max_len) replaces the
        slot's whole cache, as the JAX engine's masked `where` does."""
        slots = torch.as_tensor(np.flatnonzero(sel), device=self.device)
        for name, pool, src in self._pool_leaves(self.caches, one_caches):
            src = src.to(pool.dtype)
            shape = list(src.shape)
            shape[1] = len(slots)
            if name in ("k", "v"):
                n = src.shape[2]
                pool[:, slots, :n] = src.expand(shape)
                pool[:, slots, n:] = 0
            else:
                pool[:, slots] = src.expand(shape)

    def _read_slot(self, slot: int, n_tokens: int) -> Dict[str, Any]:
        """Inverse of `_write_slot`: a batch=1 copy of pool slot `slot`,
        k/v cropped to its first `n_tokens` positions."""
        def take(tree):
            out = {}
            for name, leaf in tree.items():
                if name == "len":
                    continue
                if isinstance(leaf, dict):
                    out[name] = take(leaf)
                elif name in ("k", "v"):
                    out[name] = leaf[:, slot:slot + 1, :n_tokens].clone()
                else:
                    out[name] = leaf[:, slot:slot + 1].clone()
            return out
        return take(self.caches)

    # ----------------------------------------------------------------- tick

    def _finish(self, req: Request, reason: str) -> None:
        # a request that ever sampled through the NaN/Inf guard completes
        # as "degraded": its tokens are usable (greedy fallback) but the
        # caller must know they were produced under a fault
        if req.degraded and reason in ("eos", "max_new", "max_len"):
            reason = "degraded"
        req.done = True
        req.finish_reason = reason
        if req.slot >= 0:
            if self._kv is not None:
                # drop every page reference the slot holds (shared prefix
                # pins, private pages, unresolved pending-COW copies);
                # pages whose refcount hits zero return to the free list
                self._kv.release_slot(req.slot)
            self.sched.retire(req.slot)
            self._slot_req.pop(req.slot, None)
            self._prefill_pos.pop(req.slot, None)
            self._chunk_hashes.pop(req.slot, None)
        self.metrics.counter("serving.requests_completed").inc()
        self.metrics.counter(f"serving.requests_completed.{reason}").inc()
        now = time.perf_counter()
        if req.submit_t:
            self.metrics.histogram("serving.request_latency_s").observe(
                now - req.submit_t)
        flight.record("serving.finish", rid=req.rid, reason=reason,
                      out_tokens=len(req.out), degraded=req.degraded)
        if obs.tracer.enabled and req.submit_t:
            # request-track epilogue: the decode phase (first -> last
            # token) and the whole-request envelope carrying the finish
            # reason, both on this rid's Perfetto track
            if req.first_tok_t and req.last_tok_t > req.first_tok_t:
                obs.tracer.complete(
                    "decode", req.first_tok_t, req.last_tok_t,
                    pid=_REQ_TRACK_PID, tid=req.rid,
                    tokens=max(len(req.out) - 1, 0))
            obs.tracer.complete("request", req.submit_t, now,
                                pid=_REQ_TRACK_PID, tid=req.rid,
                                rid=req.rid, reason=reason,
                                out_tokens=len(req.out))

    def _enforce_deadlines(self) -> None:
        """Time out queued and running requests past their TTL."""
        if not self._any_deadlines:
            return
        now = time.perf_counter()

        def expired(r: Request) -> bool:
            return (r.deadline_s is not None
                    and now - r.submit_t > r.deadline_s)

        if any(expired(r) for r in self.pending):
            keep: Deque[Request] = deque()
            for r in self.pending:
                if expired(r):
                    self._finish(r, "timeout")
                else:
                    keep.append(r)
            self.pending = keep
        for req in list(self._slot_req.values()):
            if expired(req):
                self._finish(req, "timeout")

    # ------------------------------------------------------- paged admission

    def _on_prefix_evict(self, entry: PrefixEntry) -> None:
        """PrefixCache eviction hook (paged mode): release the entry's
        page references.  Pages shared with live slots survive (refcount
        > 0); unshared ones return to the free list."""
        if entry.pages:
            freed = self._kv.pool.release(entry.pages)
            self.metrics.counter("serving.kv.evicted_pages").inc(
                len(entry.pages))
            flight.record("kv.evict", pages=len(entry.pages), freed=freed,
                          n_tokens=entry.n_tokens)
        self.metrics.counter("serving.prefix_cache.evictions").inc()

    def _admit_paged(self, req: Request) -> int:
        """Paged admission: admit only if a slot is free AND the pool
        covers the request's worst case (`ceil(min(prompt + max_new,
        max_len) / page_size)` pages, minus full pages pinned from a
        prefix hit; a shared partial page still bills one fresh page for
        its COW copy).  Pool pressure evicts LRU prefix entries before
        giving up; a request that still doesn't fit stays queued
        (`kv.oom` flight event + `serving.kv.admit_blocked`).  The prefix
        match happens here: a hit pins the entry's pages instead of
        copying the prefix into the slot."""
        if not bool((~self.sched.active).any()):
            return -1
        kv, m = self._kv, self.metrics
        cap = min(len(req.prompt) + req.max_new, self.max_len)
        matched, entry, hashes = 0, None, []
        if self.prefix is not None:
            matched, entry, hashes = self.prefix.match(req.prompt)
        shared = list(entry.pages) if (matched and entry.pages) else []
        if not shared:
            matched = 0
        else:
            kv.pool.share(shared)        # pin before any pressure eviction
        need = kv.fresh_pages_needed(cap, matched)
        while (kv.pool.free_pages < need and self.prefix is not None
               and len(self.prefix)):
            self.prefix.evict_lru()      # releases pages via _on_prefix_evict
        if kv.pool.free_pages < need:
            if shared:
                kv.pool.release(shared)
            m.counter("serving.kv.admit_blocked").inc()
            if self._last_oom_rid != req.rid:   # one flight event per
                self._last_oom_rid = req.rid    # blocked request, not tick
                flight.record("kv.oom", rid=req.rid, need_pages=need,
                              free_pages=kv.pool.free_pages)
            return -1
        slot = self.sched.admit()
        assert slot >= 0
        kv.bind(slot, cap, matched, shared)
        self._chunk_hashes[slot] = hashes
        if self.prefix is not None:
            n_chunks = matched // self.chunk
            m.counter("serving.prefix_cache.hits").inc(n_chunks)
            m.counter("serving.prefix_cache.misses").inc(
                len(hashes) - n_chunks)
            m.counter("serving.prefix_cache.hit_tokens").inc(matched)
            if obs.tracer.enabled:
                obs.tracer.instant(
                    "prefix_hit" if matched else "prefix_miss",
                    pid=_REQ_TRACK_PID, tid=req.rid, matched_tokens=matched)
        if shared:
            m.counter("serving.kv.pages_shared").inc(len(shared))
        self.lens[slot] = matched
        self._prefill_pos[slot] = matched
        return slot

    def _commit_cow(self, commits) -> None:
        """Apply the tick's COW resolutions after the device step: point
        tables at the freshly written copies, drop the shared-page refs,
        and account the split (one page written is the whole per-hit
        copy cost; full shared pages are never copied)."""
        if not commits:
            return
        self._kv.commit(commits)
        m = self.metrics
        m.counter("serving.kv.cow_splits").inc(len(commits))
        m.counter("serving.kv.pages_copied").inc(len(commits))
        for c in commits:
            flight.record("kv.cow", slot=c.slot, pos=c.pos,
                          old_page=c.old_page, new_page=c.new_page)

    def _begin_prefill_batch(self, admitted) -> None:
        """Admission-time prefix-cache lookup for a whole admission wave:
        copy the longest cached KV prefix into each slot and start its
        chunk cursor past it; slots matching the SAME entry are written
        in one masked broadcast."""
        m = self.metrics
        groups: Dict[int, list] = {}    # id(entry) -> [entry, [slots]]
        for slot, req in admitted:
            matched = 0
            if self.prefix is not None:
                matched, entry, hashes = self.prefix.match(req.prompt)
                self._chunk_hashes[slot] = hashes
                n_chunks = matched // self.chunk
                m.counter("serving.prefix_cache.hits").inc(n_chunks)
                m.counter("serving.prefix_cache.misses").inc(
                    len(hashes) - n_chunks)
                m.counter("serving.prefix_cache.hit_tokens").inc(matched)
                if obs.tracer.enabled:
                    # hit/miss marker on the request's own track, right
                    # where its prefill timeline begins
                    obs.tracer.instant(
                        "prefix_hit" if matched else "prefix_miss",
                        pid=_REQ_TRACK_PID, tid=req.rid,
                        matched_tokens=matched)
            if matched:
                groups.setdefault(id(entry), [entry, []])[1].append(slot)
            self.lens[slot] = matched
            self._prefill_pos[slot] = matched
        for entry, slots in groups.values():
            sel = np.zeros(self.n_slots, bool)
            sel[slots] = True
            self._write_slots_masked(entry.caches, sel)

    def _insert_prefix_entries(self, slot: int, req: Request) -> None:
        """After a slot finishes prefilling, snapshot the DEEPEST
        full-chunk boundary of its prompt into the prefix cache (a chain
        hash commits to its whole prefix, so shallower boundaries need no
        entries of their own)."""
        if self.prefix is None:
            return
        hashes = self._chunk_hashes.pop(slot, [])
        if not hashes:
            return
        m = self.metrics
        hkey = hashes[-1]
        n = len(hashes) * self.chunk
        if hkey in self.prefix:
            self.prefix.insert(hkey, None, n)       # recency refresh only
        elif self._kv is not None:
            # paged insert: the entry takes references on the slot's full
            # pages (no copy); a trailing partial page is copied into a
            # fresh page iff the donor will still write inside it.  Under
            # pool pressure the copy may be skipped: the entry is then
            # truncated to its full pages.
            kv = self._kv
            if kv.pool.free_pages == 0 and n % kv.page_size:
                self.prefix.evict_lru()  # make room for the partial copy
            pages, copy, n_stored = kv.entry_pages(
                slot, n, next_write_pos=int(self.lens[slot]))
            if pages:
                if copy is not None:
                    kv_pool.copy_page(self.caches, copy[0], copy[1])
                    m.counter("serving.kv.pages_copied").inc()
                # evictions are counted by _on_prefix_evict
                self.prefix.insert(hkey, None, n_stored, pages=pages)
                m.counter("serving.prefix_cache.inserts").inc()
        else:
            ev = self.prefix.insert(hkey, self._read_slot(slot, n), n)
            m.counter("serving.prefix_cache.inserts").inc()
            m.counter("serving.prefix_cache.evictions").inc(ev)
        m.gauge("serving.prefix_cache.size").set(len(self.prefix))

    def _finish_slot_prefill(self, slot: int, req: Request, tok: int) -> None:
        """Shared prefill epilogue: record TTFT, seed decode state."""
        m = self.metrics
        now = time.perf_counter()
        req.first_tok_t = req.last_tok_t = now
        m.histogram("serving.ttft_s").observe(now - req.submit_t)
        flight.record("serving.first_token", rid=req.rid, slot=slot,
                      ttft_s=round(now - req.submit_t, 6))
        if obs.tracer.enabled and req.admit_t:
            # the whole prefill phase (admission -> first token) on this
            # rid's track; the prefill_chunk intervals nest inside it
            obs.tracer.complete("prefill", req.admit_t, now,
                                pid=_REQ_TRACK_PID, tid=req.rid,
                                prompt_tokens=len(req.prompt))
        m.counter("serving.prefills").inc()
        m.counter("serving.prompt_tokens").inc(len(req.prompt))
        m.counter("serving.tokens").inc()
        self.last_tok[slot] = tok
        req.out.append(tok)
        self.lens[slot] = len(req.prompt)
        self.sched.prefill_done(slot)
        self._insert_prefix_entries(slot, req)

    def _prefill_tick_chunked(self) -> None:
        """Advance EVERY stalled slot by one chunk in one batched call."""
        targets = self.sched.prefill_targets()
        if len(targets) == 0:
            return
        m = self.metrics
        C = self.chunk
        toks = np.zeros((self.n_slots, C), np.int32)
        last_idx = np.zeros(self.n_slots, np.int32)
        seg_len = {}
        for slot in targets:
            slot = int(slot)
            req = self._slot_req[slot]
            pos = self._prefill_pos[slot]
            seg = req.prompt[pos:pos + C]
            toks[slot, :len(seg)] = seg
            last_idx[slot] = len(seg) - 1
            seg_len[slot] = len(seg)
        sel = np.zeros(self.n_slots, bool)
        sel[targets] = True
        t_chunk0 = time.perf_counter()
        with obs.trace.span("prefill_chunk", n=int(len(targets))):
            commits, plan = [], None
            if self._kv is not None:
                writes = {s: (self._prefill_pos[s],
                              self._prefill_pos[s] + L)
                          for s, L in seg_len.items()}
                rtab, wtab, wmask, commits = self._kv.write_plan(writes)
                plan = (rtab, wtab, wmask)
            tok, bad = self._prefill_chunk_step(toks, last_idx, sel, plan)
            self._commit_cow(commits)
            tok_np, bad_np = tok.cpu().numpy(), bad.cpu().numpy()
        if obs.tracer.enabled:
            # mirror the batched chunk call onto every participating
            # request's track: the shared interval shows exactly which
            # requests rode the same batched prefill call
            t_chunk1 = time.perf_counter()
            for slot in targets:
                slot = int(slot)
                obs.tracer.complete(
                    "prefill_chunk", t_chunk0, t_chunk1,
                    pid=_REQ_TRACK_PID, tid=self._slot_req[slot].rid,
                    pos=self._prefill_pos[slot], tokens=seg_len[slot])
        m.counter("serving.prefill_chunk_calls").inc()
        m.counter("serving.prefill_chunks").inc(int(len(targets)))
        m.histogram("serving.prefill_batch_width").observe(len(targets))
        for slot in targets:
            slot = int(slot)
            req = self._slot_req[slot]
            pos_new = self._prefill_pos[slot] + seg_len[slot]
            self._prefill_pos[slot] = pos_new
            self.lens[slot] = pos_new
            self.sched.prefill_step(slot)
            if pos_new >= len(req.prompt):
                if bool(bad_np[slot]):
                    req.degraded = True
                    m.counter("serving.degraded_samples").inc()
                self._finish_slot_prefill(slot, req, int(tok_np[slot]))

    def _prefill_tick_legacy(self) -> None:
        """One [1, bucket] prefill per stalled slot (buckets double from
        `prompt_bucket` until the prompt fits)."""
        m = self.metrics
        for slot in self.sched.prefill_targets():
            slot = int(slot)
            req = self._slot_req[slot]
            L = len(req.prompt)
            buck = self.bucket
            while buck < L:
                buck *= 2
            toks = np.zeros((1, buck), np.int32)
            toks[0, :L] = req.prompt
            with obs.trace.span("prefill", rid=req.rid, len=L, bucket=buck):
                tok, one, bad = self._prefill_one(toks, L)
                self._write_slot(slot, one, L)
                t = int(tok[0])
            if bool(bad[0]):
                req.degraded = True
                m.counter("serving.degraded_samples").inc()
            self.sched.prefill_step(slot)
            self._finish_slot_prefill(slot, req, t)

    def step(self) -> int:
        """One engine tick with a watchdog: transient failures (the
        injectable `TransientFault` class: flaky collectives, preempted
        devices) retry with capped exponential backoff up to
        `step_retries` times before propagating.  The injected check
        fires BEFORE any tick mutation (the port writes caches in place,
        so a retried tick must not have written anything), so a retried
        tick replays cleanly.  Slow ticks (wall time over
        `tick_budget_s`) are counted but never retried."""
        m = self.metrics
        attempt = 0
        while True:
            self.liveness.beat()
            t_tick = time.perf_counter()
            try:
                if self.faults is not None:
                    self.faults.check_raise("serving.step")
                produced = self._step_inner()
            except TransientFault as e:
                m.counter("serving.watchdog.transient_faults").inc()
                if attempt >= self.step_retries:
                    m.counter("serving.watchdog.gave_up").inc()
                    flight.record("serving.watchdog.gave_up",
                                  attempt=attempt, exc=str(e))
                    raise
                delay = min(self.retry_base_s * (2 ** attempt),
                            self.retry_max_s)
                m.counter("serving.watchdog.retries").inc()
                flight.record("serving.watchdog.retry", attempt=attempt,
                              delay_s=delay, exc=str(e))
                time.sleep(delay)
                attempt += 1
                continue
            dt = time.perf_counter() - t_tick
            m.histogram("serving.tick_s").observe(dt)
            if self.tick_budget_s is not None and dt > self.tick_budget_s:
                m.counter("serving.watchdog.slow_ticks").inc()
                flight.record("serving.watchdog.slow_tick",
                              dt_s=round(dt, 6), budget_s=self.tick_budget_s)
            return produced

    def _step_inner(self) -> int:
        """One engine tick: time out -> admit -> prefill -> decode.
        Returns the number of *decode* tokens produced this tick.

        `max_new` counts decode tokens after prefill; the prefill pass
        samples one more, so a request that never hits EOS/max_len
        finishes with ``len(req.out) == max_new + 1``."""
        m = self.metrics
        self._enforce_deadlines()
        admitted = []
        while self.pending:
            if self._kv is not None:
                # paged admission peeks: match + pin + allocate first,
                # claim the slot only once the pool covers the request
                slot = self._admit_paged(self.pending[0])
            else:
                slot = self.sched.admit()
            if slot < 0:
                break
            req = self.pending.popleft()
            req.slot = slot
            req.admit_t = time.perf_counter()
            self._slot_req[slot] = req
            admitted.append((slot, req))
            flight.record("serving.admit", rid=req.rid, slot=slot,
                          prompt_tokens=len(req.prompt))
            if obs.tracer.enabled:
                # open this rid's Perfetto track: name it and lay the
                # queue-wait interval (submit -> admit) as its first span
                obs.tracer.thread_name(_REQ_TRACK_PID, req.rid,
                                       f"req {req.rid}")
                obs.tracer.complete("queue_wait", req.submit_t, req.admit_t,
                                    pid=_REQ_TRACK_PID, tid=req.rid,
                                    slot=slot)
        if admitted and self._kv is None:
            self._begin_prefill_batch(admitted)
        if self._kv is not None:
            self._set_pool_gauges()
        m.gauge("serving.queue_depth").set(len(self.pending))
        m.gauge("serving.slot_occupancy").set(
            float(self.sched.active.sum()) / self.n_slots)

        # 2. prefill stalled slots: chunked slots stay stalled but
        # progressing across ticks; legacy slots fill in one call each
        if self.faults is not None:
            d = self.faults.delay_s("serving.prefill")
            if d:
                m.counter("serving.faults.delayed_prefill_ticks").inc()
                time.sleep(d)
        if self.prefill_mode == "chunked":
            self._prefill_tick_chunked()
        else:
            self._prefill_tick_legacy()

        picked = self.sched.next_batch(self.decode_width)
        if not picked:
            return 0
        sel = np.zeros(self.n_slots, bool)
        sel[picked] = True
        m.counter("serving.decode_ticks").inc()
        m.counter("serving.decode_lanes_selected").inc(len(picked))
        m.counter("serving.decode_lanes_total").inc(self.n_slots)
        m.gauge("serving.decode_batch_efficiency").set(
            len(picked) / self.n_slots)
        fault_code = 0
        if self.faults is not None:
            d = self.faults.delay_s("serving.decode")
            if d:
                m.counter("serving.faults.delayed_decode_ticks").inc()
                time.sleep(d)
            fault_code = self.faults.logit_fault_code("serving.logits")
        with obs.trace.span("decode_tick", n=len(picked)):
            commits, plan = [], None
            if self._kv is not None:
                writes = {int(s): (int(self.lens[s]), int(self.lens[s]) + 1)
                          for s in picked}
                rtab, wtab, wmask, commits = self._kv.write_plan(writes)
                plan = (rtab, wtab, wmask)
            new_tok, bad, ent = self._decode_step(self.last_tok, sel,
                                                  fault_code, plan)
            self._commit_cow(commits)
            toks_np, bad_np = new_tok.cpu().numpy(), bad.cpu().numpy()
        ctrs = obs.bump(obs.device_counters("sampled_tokens", "eos_sampled",
                                            "nonfinite_logit_rows"),
                        sampled_tokens=len(toks_np),
                        eos_sampled=(toks_np == self.eos_id).sum(),
                        nonfinite_logit_rows=(bad_np & sel).sum())
        obs.merge_device(m, ctrs, prefix="serving.decode.")
        ent = float(ent)
        if np.isfinite(ent):     # a faulted tick's entropy is NaN/Inf
            m.histogram("serving.decode.logit_entropy").observe(ent)

        produced = 0
        now = time.perf_counter()
        for slot in picked:
            req = self._slot_req[slot]
            t = int(toks_np[slot])
            if bool(bad_np[slot]):
                req.degraded = True
                m.counter("serving.degraded_samples").inc()
            req.out.append(t)
            if req.last_tok_t:
                m.histogram("serving.itl_s").observe(now - req.last_tok_t)
            req.last_tok_t = now
            self.last_tok[slot] = t
            self.lens[slot] += 1
            produced += 1
            if t == self.eos_id:
                self._finish(req, "eos")
            elif len(req.out) - 1 >= req.max_new:     # prefill tok excluded
                self._finish(req, "max_new")
            elif self.lens[slot] >= self.max_len - 1:
                self._finish(req, "max_len")
        m.counter("serving.tokens").inc(produced)
        m.gauge("serving.tokens_per_s").set(
            m.counter("serving.tokens").value
            / max(time.perf_counter() - self._t_start, 1e-9))
        return produced

    def run(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not (self.pending or self.sched.active.any()):
                break
            self.step()

    def results(self) -> Dict[int, List[int]]:
        return {rid: r.out for rid, r in self.requests.items()}

    def _set_pool_gauges(self) -> None:
        free = self._kv.pool.free_pages
        self.metrics.gauge("serving.kv.free_pages").set(free)
        self.metrics.gauge("serving.kv.pool_occupancy").set(
            1.0 - free / self._kv.pool.n_pages)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-serializable summary of every serving instrument."""
        if self.prefix is not None:
            self.metrics.gauge("serving.prefix_cache.size").set(
                len(self.prefix))
        if self._kv is not None:
            self._set_pool_gauges()
        return self.metrics.snapshot()

    def debug_requests(self, max_done: int = 32) -> List[Dict[str, Any]]:
        """JSON-serializable state of every request the engine knows:
        in-flight requests (queued / prefill / decode) in full, finished
        ones capped to the most recent `max_done` so a long-lived
        server's `/debug/requests` response stays bounded."""
        now = time.perf_counter()
        rows: List[Dict[str, Any]] = []
        done_rows: List[Dict[str, Any]] = []
        for rid, req in self.requests.items():
            if req.done:
                state = "done"
            elif req.slot < 0:
                state = "queued"
            elif req.slot in self._prefill_pos \
                    and self._prefill_pos[req.slot] < len(req.prompt) \
                    or not req.first_tok_t:
                state = "prefill"
            else:
                state = "decode"
            row = {"rid": rid, "state": state, "slot": req.slot,
                   "prompt_tokens": len(req.prompt),
                   "out_tokens": len(req.out),
                   "max_new": req.max_new,
                   "finish_reason": req.finish_reason or None,
                   "age_s": round(now - req.submit_t, 4)
                   if req.submit_t else None,
                   "deadline_s": req.deadline_s,
                   "degraded": req.degraded}
            (done_rows if req.done else rows).append(row)
        return rows + done_rows[-max_done:]
