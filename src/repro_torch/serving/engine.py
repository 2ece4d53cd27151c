"""Serving engine: continuous batching over a slotted KV-cache pool.  The
twin of ``repro.serving.engine`` for the contiguous KV layout.

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

Failure semantics: per-request deadlines (finish reason "timeout"), a
bounded admission queue with a shed policy ("shed"), and a NaN/Inf
logit guard that degrades to greedy sampling ("degraded").

Not in this slice (each raises ``NotImplementedError`` or is absent):
the paged KV layout (``kv_layout="paged"``), fault injection
(``faults=``) with the step watchdog's retries, the tracing/flight/HTTP
observability plane, and the ``serving.recompiles.*`` counters, which
read the JAX jit cache (PyTorch runs eagerly and has none).
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
from repro_torch.models import api
from repro_torch.models.params import Model
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import (SamplerConfig, logit_entropy,
                                         sample_guarded)
from repro_torch.serving.scheduler import RequestScheduler


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
                 faults: Any = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new",
                 default_deadline_s: Optional[float] = None,
                 tick_budget_s: Optional[float] = None):
        """The device is the params' device.  prefill_mode: 'chunked' |
        'legacy' | 'auto' (chunked when the family supports chunk-append
        cache writes and the cache is not a ring).  prefix_cache_entries
        bounds the LRU pool of KV prefix snapshots; 0 disables it.
        max_queue bounds the admission queue: a submit beyond it is SHED
        per `shed_policy` ("reject-new" or "drop-oldest").  Requests
        past their TTL (`default_deadline_s` when submitted without one)
        finish with reason "timeout".  Ticks slower than `tick_budget_s`
        bump serving.watchdog.slow_ticks."""
        if kv_layout != "contiguous":
            raise NotImplementedError(
                f"kv_layout={kv_layout!r}: the paged KV layout comes with "
                "slice 2 of the port; use 'contiguous'")
        if faults is not None:
            raise NotImplementedError(
                "fault injection (faults=) comes with a later slice of the "
                "port, with the step watchdog's retries")
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
        self.max_queue = max_queue
        if shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        self.shed_policy = shed_policy
        self.default_deadline_s = default_deadline_s
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

        # the pool: a tree of stacked [L, n_slots, ...] leaves (k/v
        # [L, n_slots, max_len, KV, D]; a hybrid model's SSM and conv
        # states have no sequence axis); the host `self.lens` is
        # authoritative and is copied into the pool's per-slot `len`
        # before every device step
        self.caches = api.init_caches(cfg, n_slots, max_len,
                                      device=self.device)
        self.lens = np.zeros(n_slots, np.int32)
        self.last_tok = np.zeros(n_slots, np.int32)

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

    def _prefill_chunk_step(self, tokens: np.ndarray, last_idx: np.ndarray,
                            sel: np.ndarray):
        """Batched chunk prefill over the WHOLE pool: tokens [n_slots,
        chunk]; last_idx [n_slots] indexes each finishing slot's last
        prompt token.  Only the slots in `sel` write their caches."""
        self._sync_len()
        logits, _aux, _ = api.forward(
            self.params, {"tokens": torch.as_tensor(tokens)}, self.cfg,
            mode="chunk", caches=self.caches, rows=self._rows(sel))
        rows = torch.arange(self.n_slots, device=self.device)
        last = logits[rows, torch.as_tensor(last_idx, device=self.device)
                      .long()]
        return sample_guarded(last, self.cfg.vocab_size, self.sampler,
                              self._gen)

    def _decode_step(self, tokens: np.ndarray, sel: np.ndarray):
        self._sync_len()
        logits, _aux, _ = api.forward(
            self.params, {"tokens": torch.as_tensor(tokens)[:, None]},
            self.cfg, mode="decode", caches=self.caches,
            rows=self._rows(sel))
        last = logits[:, -1]
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
        offset 0, cropped to max_len); positions past it keep their
        contents, masked by the slot's len and overwritten by decode."""
        for name, pool, src in self._pool_leaves(self.caches, one_caches):
            if name in ("k", "v"):
                n = min(src.shape[2], self.max_len)
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
            self.sched.retire(req.slot)
            self._slot_req.pop(req.slot, None)
            self._prefill_pos.pop(req.slot, None)
            self._chunk_hashes.pop(req.slot, None)
        self.metrics.counter("serving.requests_completed").inc()
        self.metrics.counter(f"serving.requests_completed.{reason}").inc()
        if req.submit_t:
            self.metrics.histogram("serving.request_latency_s").observe(
                time.perf_counter() - req.submit_t)

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
        tok, bad = self._prefill_chunk_step(toks, last_idx, sel)
        tok_np, bad_np = tok.cpu().numpy(), bad.cpu().numpy()
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
            tok, one, bad = self._prefill_one(toks, L)
            self._write_slot(slot, one, L)
            t = int(tok[0])
            if bool(bad[0]):
                req.degraded = True
                m.counter("serving.degraded_samples").inc()
            self.sched.prefill_step(slot)
            self._finish_slot_prefill(slot, req, t)

    def step(self) -> int:
        """One engine tick; ticks slower than `tick_budget_s` are
        counted (serving.watchdog.slow_ticks), never retried."""
        m = self.metrics
        t_tick = time.perf_counter()
        produced = self._step_inner()
        dt = time.perf_counter() - t_tick
        m.histogram("serving.tick_s").observe(dt)
        if self.tick_budget_s is not None and dt > self.tick_budget_s:
            m.counter("serving.watchdog.slow_ticks").inc()
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
            slot = self.sched.admit()
            if slot < 0:
                break
            req = self.pending.popleft()
            req.slot = slot
            req.admit_t = time.perf_counter()
            self._slot_req[slot] = req
            admitted.append((slot, req))
        if admitted:
            self._begin_prefill_batch(admitted)
        m.gauge("serving.queue_depth").set(len(self.pending))
        m.gauge("serving.slot_occupancy").set(
            float(self.sched.active.sum()) / self.n_slots)

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
        new_tok, bad, ent = self._decode_step(self.last_tok, sel)
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

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-serializable summary of every serving instrument."""
        if self.prefix is not None:
            self.metrics.gauge("serving.prefix_cache.size").set(
                len(self.prefix))
        return self.metrics.snapshot()
