#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and a checkout of the repository around this file;
without either it exits non-zero and prints no result.  Imports nothing
of JAX and nothing of the ``repro`` package.  In order:

1. builds the four CUDA kernels (RMSNorm, flash-attention forward, MoE
   gather, SSD intra-chunk) from ``src/repro_torch/csrc/``, one
   ``nvcc`` per source, in parallel;
2. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes (the gather bit-exact; flash in bf16 on its
   wgmma/TMA route and in fp32 on its FMA route, also at zamba2's
   head_dim 112, and in bf16 at long prefills of 4096 tokens and a
   ragged S = 200), and reduced fp32 phi3, deepseek-moe-16b and
   zamba2-7b prefills on the card (kernels) against the same models on
   the CPU (plain versions);
3. serves three models at full published width in bf16, one on the
   card at a time, with random weights from a seeded generator:
   ``phi3-mini-3.8b`` (a) chunked prefill, 4 requests on 2 slots behind
   a 64-token shared prefix, so the prefix cache hits, (b) legacy
   bucketed prefill, 2 requests; ``deepseek-moe-16b`` (c) chunked, as
   (a), (d) legacy, as (b); ``zamba2-7b`` (e) legacy, prompts of
   exactly 64 and 128 tokens, so no pad enters the recurrent state.
   Each path runs with every kernel's launch count set to 0 just before
   it and read just after (flash's per route too: bf16 serving must
   run it on the wgmma route only);
4. checks consistency: phi3's chunked and legacy first-token logits
   (cosine >= 0.99); zamba2's prefill(64) + one decode step against the
   last logits of prefill(65) (cosine >= 0.99); deepseek's chunked vs
   legacy first-token cosine is printed only (see there); and profiles
   one prefill and one decode forward of each model (wall vs device
   time, the kernels with most device time);
5. times each kernel, its plain version and the PyTorch library call
   where one computes the same function, with CUDA events: device time
   per call (``ms``, from CUDA-graph replays) and time per eager call
   (``call_ms``, host included); flash also at the long prefills.

It prints a ``{"serve": ...}`` line, a ``{"timings": ...}`` line, one
``{"kernels": [...]}`` line, the card's name and power limit, and ends
with ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
PHI3, DEEPSEEK, ZAMBA = "phi3-mini-3.8b", "deepseek-moe-16b", "zamba2-7b"
KERNELS = ("rmsnorm", "flash_attention", "moe_gather", "ssd_intra")
OUR_KERNELS = {  # kernel: its CUDA functions' names, as the profiler shows
    "rmsnorm": ("rmsnorm_kernel",), "flash_attention": ("flash_fwd_",),
    "moe_gather": ("moe_gather_kernel",),
    "ssd_intra": ("ssd_y_kernel", "ssd_state_kernel")}
SEED = 0


def _imports():
    """The port's modules this script uses (import-hygiene tests call
    this: none of them may pull in JAX or ``repro``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_dispatch import ops as gather_ops
    from repro_torch.kernels.moe_dispatch.ref import moe_gather_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_scan.ref import ssd_intra_ref
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine
    return dict(np=np, torch=torch, F=F, bridge=bridge,
                get_config=get_config, reduced_config=reduced_config,
                build=build, fa_ops=fa_ops, attention_ref=attention_ref,
                gather_ops=gather_ops, moe_gather_ref=moe_gather_ref,
                rms_ops=rms_ops, rmsnorm_ref=rmsnorm_ref, ssd_ops=ssd_ops,
                ssd_intra_ref=ssd_intra_ref, api=api, Engine=Engine,
                counted={"rmsnorm": rms_ops, "flash_attention": fa_ops,
                         "moe_gather": gather_ops, "ssd_intra": ssd_ops})


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _zero_counts(m) -> None:
    for mod in m["counted"].values():
        mod.launches = 0
    for route in m["fa_ops"].launches_by_route:
        m["fa_ops"].launches_by_route[route] = 0


def _counts(m) -> dict:
    return {name: mod.launches for name, mod in m["counted"].items()}


def _time_ms(torch, fn, reps: int = 25, inner: int = 10) -> float:
    """Time per call as a caller sees it: median over `reps` of the mean
    of `inner` back-to-back eager calls, from CUDA events, after a
    warm-up.  Includes host time (Python, launch) where the host is
    slower than the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _device_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Device time per call: `inner` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events; median per call.  No
    host time is left in the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _times(torch, kernel, plain, library) -> dict:
    """Device and per-call times of a kernel, its plain version and,
    where one exists, the library call computing the same function."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            out[f"{key}ms"] = out[f"{key}call_ms"] = None
            continue
        out[f"{key}ms"] = _device_ms(torch, fn)
        out[f"{key}call_ms"] = _time_ms(torch, fn)
    return out


def _bound(nbytes: float, flops: float, peak: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _max_err(torch, got, want, tol: float, what: str) -> float:
    g, w = got.float(), want.float()
    _check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    _check(not bool(bad.any()),
           f"{what}: max error {float(err.max())} above tolerance {tol}")
    return float(err.max())


def _cosine(torch, a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))


# ---------------------------------------------------------------------------
# inputs at the main paths' shapes
# ---------------------------------------------------------------------------

def gather_inputs(torch, g, T, d, E, C, dtype):
    """x [T, d] and slot_token [E*C] with empty (-1), out-of-range (>= T)
    and duplicate slots, from generator `g` on the card."""
    x = torch.randn(T, d, generator=g, device="cuda").to(dtype)
    st = torch.full((E * C,), -1, dtype=torch.int32, device="cuda")
    n = min(E * C, T * 6)                      # top-6 pairs, some dropped
    st[:n] = torch.randint(0, T, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    st[n:n + 2] = torch.tensor([T, T + 3], dtype=torch.int32, device="cuda")
    perm = torch.randperm(E * C, generator=g, device="cuda")
    return x, st[perm].contiguous()


def ssd_inputs(torch, g, nc, Q, H=112, P=64, N=64):
    cum = torch.cumsum(-0.1 * torch.rand(1, nc, Q, H, generator=g,
                                         device="cuda"), dim=2)
    return (cum, torch.randn(1, nc, Q, H, P, generator=g, device="cuda"),
            torch.randn(1, nc, Q, N, generator=g, device="cuda"),
            torch.randn(1, nc, Q, N, generator=g, device="cuda"))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_phase(m) -> dict:
    """Each kernel against its plain version at the main paths' shapes."""
    torch = m["torch"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {name: 0.0 for name in KERNELS}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        for rows, d in ((4, 3072), (128, 3072), (256, 3072), (64, 2048),
                        (128, 7168)):
            x = torch.randn(rows, d, generator=g, device="cuda").to(dt)
            s = torch.randn(d, generator=g, device="cuda").to(dt)
            got = m["rms_ops"].rmsnorm_cuda(x, s)
            torch.cuda.synchronize()
            e = _max_err(torch, got, m["rmsnorm_ref"](x, s), tol,
                         f"rmsnorm {dt} [{rows},{d}]")
            errs["rmsnorm"] = max(errs["rmsnorm"], e)
    cases = [  # (S, H, KV, D, window): phi3, deepseek, zamba2 shapes
        (64, 32, 32, 96, None), (256, 32, 32, 96, None),
        (256, 32, 8, 96, None), (256, 32, 32, 96, 64),
        (128, 16, 16, 128, None), (64, 32, 32, 112, None),
        (65, 32, 32, 112, None), (128, 32, 32, 112, 48)]
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for S, H, KV, D, w in cases:
            q = torch.randn(1, S, H, D, generator=g, device="cuda").to(dt)
            k = torch.randn(1, S, KV, D, generator=g, device="cuda").to(dt)
            v = torch.randn(1, S, KV, D, generator=g, device="cuda").to(dt)
            got = m["fa_ops"].flash_attention_cuda(q, k, v, causal=True,
                                                   window=w)
            torch.cuda.synchronize()
            want = m["attention_ref"](q, k, v, causal=True, window=w)
            e = _max_err(torch, got, want, tol,
                         f"flash {dt} S={S} H={H} KV={KV} D={D} window={w}")
            errs["flash_attention"] = max(errs["flash_attention"], e)
    # bf16 only: long prefills of phi3 and deepseek (many kv tiles through
    # the TMA ring) and a ragged S = 200 at zamba2's head_dim
    for S, H, KV, D, w in ((4096, 32, 32, 96, None), (4096, 16, 16, 128, None),
                           (200, 32, 32, 112, None)):
        q, k, v = (torch.randn(1, S, h, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for h in (H, KV, KV))
        got = m["fa_ops"].flash_attention_cuda(q, k, v, causal=True, window=w)
        torch.cuda.synchronize()
        want = m["attention_ref"](q, k, v, causal=True, window=w)
        e = _max_err(torch, got, want, 2e-2,
                     f"flash bf16 S={S} H={H} KV={KV} D={D} window={w}")
        errs["flash_attention"] = max(errs["flash_attention"], e)
        del q, k, v, got, want
    for dt in (torch.bfloat16, torch.float32):
        for T, C in ((2, 8), (64, 8), (128, 16)):
            x, st = gather_inputs(torch, g, T, 2048, 64, C, dt)
            got = m["gather_ops"].moe_gather_cuda(x, st, 64, C)
            torch.cuda.synchronize()
            _check(torch.equal(got, m["moe_gather_ref"](x, st, 64, C)),
                   f"moe gather {dt} T={T} C={C}: not bit-exact")
    for nc, Q in ((1, 64), (1, 65), (1, 128), (2, 256)):
        args = ssd_inputs(torch, g, nc, Q)
        y, s = m["ssd_ops"].ssd_intra_cuda(*args)
        torch.cuda.synchronize()
        yr, sr = m["ssd_intra_ref"](*args)
        e = max(_max_err(torch, y, yr, 1e-4, f"ssd y nc={nc} Q={Q}"),
                _max_err(torch, s, sr, 1e-4, f"ssd S nc={nc} Q={Q}"))
        errs["ssd_intra"] = max(errs["ssd_intra"], e)
    return errs


def reduced_model_phase(m) -> dict:
    """Reduced fp32 models' prefill logits: card (kernels) vs CPU
    (plain versions), same weights; the kernels launch once per layer
    that runs them."""
    torch, api, bridge = m["torch"], m["api"], m["bridge"]
    out = {}
    for arch, layers in ((PHI3, 2), (DEEPSEEK, 4), (ZAMBA, 4)):
        cfg = m["reduced_config"](arch).replace(num_layers=layers,
                                                dtype="float32")
        cpu = api.build_params(cfg, torch.Generator().manual_seed(SEED),
                               device="cpu")
        gpu = bridge.from_numpy(bridge.to_numpy(cpu), cfg, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(SEED))
        want, _, _ = api.forward(cpu, {"tokens": toks}, cfg, mode="prefill")
        _zero_counts(m)
        got, _, _ = api.forward(gpu, {"tokens": toks}, cfg, mode="prefill")
        n = _counts(m)
        if cfg.family == "hybrid":
            _check(n["ssd_intra"] == layers and n["flash_attention"]
                   == layers // cfg.attn_every,
                   f"{arch}: SSD/flash launches {n} per prefill")
        else:
            _check(n["flash_attention"] == layers,
                   f"{arch}: flash launches {n} per prefill")
        if cfg.is_moe:
            _check(n["moe_gather"] == layers - cfg.moe.first_k_dense,
                   f"{arch}: gather launches {n} per prefill")
        out[arch] = {"max_abs_err": _max_err(torch, got.cpu(), want, 1e-3,
                                             f"reduced fp32 {arch}"),
                     "launches": n}
    return out


def _serve(m, cfg, params, prompts, max_new, **kw) -> dict:
    """One engine run with every launch count zeroed just before it."""
    torch = m["torch"]
    eng = m["Engine"](cfg, params, n_slots=2, max_len=256, eos_id=-1,
                      prefill_chunk=32, **kw)
    _zero_counts(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(m)
    routes = dict(m["fa_ops"].launches_by_route)
    res = eng.results()
    for r in rids:
        _check(len(res[r]) == max_new + 1,
               f"request {r}: {len(res[r])} tokens, want {max_new + 1}")
        _check(eng.requests[r].finish_reason == "max_new",
               f"request {r} finished {eng.requests[r].finish_reason}")
    snap = eng.metrics_snapshot()
    tokens = sum(len(res[r]) for r in rids)
    return {"arch": cfg.name, "mode": eng.prefill_mode,
            "requests": len(rids), "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_s_mean": snap["serving.ttft_s"]["mean"],
            "ttft_s_max": snap["serving.ttft_s"]["max"],
            "prefix_cache_hits": snap.get(
                "serving.prefix_cache.hits", {}).get("value", 0),
            "prefills": snap["serving.prefills"]["value"],
            "decode_ticks": snap["serving.decode_ticks"]["value"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "flash_launches_by_route": routes}


def first_token_logits(m, cfg, params, prompt):
    """The last prompt token's logits through chunked prefill (chunk
    mode into a cache) and legacy prefill (flash kernel, bucket 128)."""
    torch, api = m["torch"], m["api"]
    caches = api.init_caches(cfg, 1, 256, device="cuda")
    for p0 in range(0, len(prompt), 32):
        seg = prompt[p0:p0 + 32]
        toks = torch.zeros((1, 32), dtype=torch.int32)
        toks[0, :len(seg)] = torch.tensor(seg)
        caches["len"] = torch.tensor([p0], dtype=torch.int32, device="cuda")
        logits, _, _ = api.forward(params, {"tokens": toks}, cfg,
                                   mode="chunk", caches=caches)
    chunked = logits[0, len(seg) - 1].float()
    toks = torch.zeros((1, 128), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    logits, _, _ = api.forward(params, {"tokens": toks}, cfg,
                               mode="prefill")
    legacy = logits[0, len(prompt) - 1].float()
    return chunked, legacy


def decode_vs_prefill(m, cfg, params, prompt) -> float:
    """Cosine of prefill(L) + one decode step against the last logits of
    prefill(L + 1): the SSD kernel, ssd_decode_step, the conv state and
    the shared block's KV cache together."""
    torch, api = m["torch"], m["api"]
    L = len(prompt) - 1
    toks = torch.tensor([prompt])
    _, _, caches = api.forward(params, {"tokens": toks[:, :L]}, cfg,
                               mode="prefill")
    caches = api.grow_caches(cfg, caches, L + 8)
    caches["len"] = torch.tensor([L], dtype=torch.int32, device="cuda")
    step, _, _ = api.forward(params, {"tokens": toks[:, L:]}, cfg,
                             mode="decode", caches=caches)
    full, _, _ = api.forward(params, {"tokens": toks}, cfg, mode="prefill")
    a, b = step[0, -1].float(), full[0, -1].float()
    _check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
           f"{cfg.name}: non-finite logits")
    return _cosine(torch, a, b)


def step_profile(m, cfg, params) -> dict:
    """One legacy prefill ([1, 64]) and one decode step of a 2-slot pool
    under ``torch.profiler``, each after a warm-up call: wall ms (host
    clock around the call, synchronised; profiler overhead included),
    device ms (sum of the kernels' self device times), the device's busy
    share, the number of kernels, the five kernels with the most device
    time, and the device ms and launches of each hand-written kernel."""
    torch, api = m["torch"], m["api"]
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(SEED)
    caches = api.init_caches(cfg, 2, 256, device="cuda")
    caches["len"] = torch.tensor([64, 64], dtype=torch.int32, device="cuda")
    calls = {
        "prefill": lambda: api.forward(
            params, {"tokens": torch.randint(0, cfg.vocab_size, (1, 64),
                                             generator=g)},
            cfg, mode="prefill"),
        "decode": lambda: api.forward(
            params, {"tokens": torch.randint(0, cfg.vocab_size, (2, 1),
                                             generator=g)},
            cfg, mode="decode", caches=dict(caches))}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        ours = {k: [sum(e.self_device_time_total for e in kern
                        if any(f in e.key for f in fns)) / 1e3,
                    sum(e.count for e in kern
                        if any(f in e.key for f in fns))]
                for k, fns in OUR_KERNELS.items()}
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "busy_share": dev / wall,
                     "kernels": sum(e.count for e in kern),
                     "top": [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in top],
                     "ours": ours}
    return out


def _build_model(m, arch):
    torch = m["torch"]
    cfg = m["get_config"](arch)
    t0 = time.perf_counter()
    params = m["api"].build_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {arch} full width, {cfg.num_layers} layers, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B params "
          f"bf16, init {time.perf_counter() - t0:.3f}s", flush=True)
    return cfg, params


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_phase(m) -> dict:
    torch, np = m["torch"], m["np"]
    rng = np.random.default_rng(SEED)
    out = {}

    def prompts(cfg):
        shared = rng.integers(0, cfg.vocab_size, 64).tolist()
        chunked = [shared + rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(2, 12))).tolist()
                   for _ in range(4)]
        legacy = [rng.integers(0, cfg.vocab_size,
                               int(rng.integers(40, 100))).tolist()
                  for _ in range(2)]
        return chunked, legacy

    # dense: phi3-mini-3.8b
    cfg, params = _build_model(m, PHI3)
    pa, pb = prompts(cfg)
    out["phi3_chunked"] = _serve(m, cfg, params, pa, 8,
                                 prefill_mode="chunked",
                                 prefix_cache_entries=32)
    out["phi3_legacy"] = _serve(m, cfg, params, pb, 8, prefill_mode="legacy")
    chunked, legacy = first_token_logits(m, cfg, params, pa[0])
    cos = _cosine(torch, chunked, legacy)
    # the two paths do the same bf16 math with fp32 attention; they
    # differ only in where sums are rounded (chunk attention over the
    # cache vs the flash kernel's tiles), a few bf16 ulps per layer
    _check(cos >= 0.99, f"phi3 chunked vs legacy first-token cosine {cos}")
    out["phi3_first_token_cosine"] = cos
    out["phi3_profile"] = step_profile(m, cfg, params)
    del params
    _free(torch)

    # MoE: deepseek-moe-16b
    cfg, params = _build_model(m, DEEPSEEK)
    pa, pb = prompts(cfg)
    out["deepseek_chunked"] = _serve(m, cfg, params, pa, 8,
                                     prefill_mode="chunked",
                                     prefix_cache_entries=32)
    out["deepseek_legacy"] = _serve(m, cfg, params, pb, 8,
                                    prefill_mode="legacy")
    chunked, legacy = first_token_logits(m, cfg, params, pa[0])
    # printed, not asserted: MoE capacity drops couple a token's output
    # to the other tokens of its batch (the other chunk positions and
    # pads here, the 128-token bucket there: C = 8 vs 16), so the two
    # paths route different token sets and need not agree
    out["deepseek_first_token_cosine"] = _cosine(torch, chunked, legacy)
    out["deepseek_profile"] = step_profile(m, cfg, params)
    del params
    _free(torch)

    # hybrid: zamba2-7b, prompts of exactly one bucket (64, 128 tokens)
    cfg, params = _build_model(m, ZAMBA)
    pz = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (64, 128)]
    out["zamba_legacy"] = _serve(m, cfg, params, pz, 8,
                                 prefill_mode="legacy")
    cos = decode_vs_prefill(m, cfg, params, pz[1][:65])
    _check(cos >= 0.99, f"zamba2 prefill+decode vs prefill cosine {cos}")
    out["zamba_decode_vs_prefill_cosine"] = cos
    out["zamba_profile"] = step_profile(m, cfg, params)
    del params
    _free(torch)

    _check(out["phi3_chunked"]["prefix_cache_hits"] > 0,
           "no prefix-cache hit in phi3 chunked")
    _check(out["deepseek_chunked"]["prefix_cache_hits"] > 0,
           "no prefix-cache hit in deepseek chunked")
    expect = {"phi3_chunked": ("rmsnorm",),
              "phi3_legacy": ("rmsnorm", "flash_attention"),
              "deepseek_chunked": ("rmsnorm", "moe_gather"),
              "deepseek_legacy": ("rmsnorm", "flash_attention",
                                  "moe_gather"),
              "zamba_legacy": ("rmsnorm", "flash_attention", "ssd_intra")}
    for path, names in expect.items():
        for name in names:
            _check(out[path]["launches"][name] > 0,
                   f"no {name} launch in {path}")
        # bf16 serving runs flash on the tensor-core route only
        _check(out[path]["flash_launches_by_route"]
               == {"wgmma": out[path]["launches"]["flash_attention"],
                   "fma": 0},
               f"{path}: flash routes {out[path]['flash_launches_by_route']}")
    return out


def timing_phase(m) -> dict:
    """Kernel, plain version and library call at the main paths' shapes
    (hot L2: the path's caller has just written these inputs)."""
    torch, F = m["torch"], m["F"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {name: [] for name in KERNELS}
    bf = torch.bfloat16
    # rmsnorm: phi3 decode (2 slots), chunk (2 x 32), legacy bucket
    for rows, d in ((2, 3072), (64, 3072), (128, 3072)):
        x = torch.randn(rows, d, generator=g, device="cuda").to(bf)
        s = torch.randn(d, generator=g, device="cuda").to(bf)
        out["rmsnorm"].append({
            "shape": [rows, d], "dtype": "bfloat16",
            **_times(torch, lambda: m["rms_ops"].rmsnorm_cuda(x, s),
                     lambda: m["rmsnorm_ref"](x, s),
                     lambda: F.rms_norm(x, (d,), s, 1e-5)),
            **_bound(2 * (2 * rows * d + d), 4 * rows * d, FP32_FLOPS)})
    # flash: legacy prefill buckets of phi3 (D=96), deepseek (D=128) and
    # zamba2 (D=112), then long prefills of phi3 and deepseek
    for S, H, D in ((64, 32, 96), (128, 32, 96), (128, 16, 128),
                    (64, 32, 112), (128, 32, 112), (4096, 32, 96),
                    (4096, 16, 128)):
        q = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        k = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        v = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2                    # causal (q, k) pairs
        out["flash_attention"].append({
            "shape": [1, S, H, D], "dtype": "bfloat16", "causal": True,
            **_times(torch,
                     lambda: m["fa_ops"].flash_attention_cuda(
                         q, k, v, causal=True),
                     lambda: m["attention_ref"](q, k, v, causal=True),
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True)),
            **_bound(2 * 4 * S * H * D, 4 * D * pairs * H, BF16_FLOPS)})
    # gather: deepseek decode (T=2), chunk (2 x 32), legacy buckets; the
    # library call is index_select over x with one zero row appended
    # (empty slots pointed at it), both made before the timed call
    for T, C in ((2, 8), (64, 8), (128, 16)):
        E, d = 64, 2048
        x, st = gather_inputs(torch, g, T, d, E, C, bf)
        valid = (st >= 0) & (st < T)
        xz = torch.cat([x, torch.zeros(1, d, dtype=bf, device="cuda")])
        idx = torch.where(valid, st, torch.full_like(st, T)).long()
        filled = int(valid.sum())
        out["moe_gather"].append({
            "shape": [T, d, E, C], "dtype": "bfloat16", "filled": filled,
            **_times(torch,
                     lambda: m["gather_ops"].moe_gather_cuda(x, st, E, C),
                     lambda: m["moe_gather_ref"](x, st, E, C),
                     lambda: torch.index_select(xz, 0, idx)),
            **_bound(2 * d * (filled + E * C) + 4 * E * C, 0, BF16_FLOPS)})
    # SSD: zamba2's legacy prefill chunks (nc=1, Q = 64, 128); no single
    # PyTorch call computes it
    for nc, Q in ((1, 64), (1, 128)):
        H, P, N = 112, 64, 64
        args = ssd_inputs(torch, g, nc, Q)
        pairs = Q * (Q + 1) // 2
        flops = nc * (pairs * 2 * N + H * pairs * (2 + 2 * P)
                      + H * Q * (N + 2 * N * P))
        nbytes = 4 * nc * (Q * H + 2 * Q * H * P + 2 * Q * N + H * N * P)
        out["ssd_intra"].append({
            "shape": [1, nc, Q, H, P, N], "dtype": "float32",
            **_times(torch, lambda: m["ssd_ops"].ssd_intra_cuda(*args),
                     lambda: m["ssd_intra_ref"](*args), None),
            **_bound(nbytes, flops, FP32_FLOPS)})
    return out


def _card() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        line = res.stdout.strip().splitlines()
        return line[0] if line else f"nvidia-smi gave no output: {res.stderr}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: no src/repro_torch beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    m = _imports()
    torch = m["torch"]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    reports = m["build"].build()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {regs}", file=sys.stderr)
    print(f"[build] {len(reports)} kernels in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    errs = kernel_phase(m)
    print(f"[kernels] max abs error vs plain: {errs}", flush=True)
    reduced = reduced_model_phase(m)
    print(f"[kernels] reduced fp32 prefill, card vs cpu: {reduced}",
          flush=True)

    serve = serve_phase(m)
    print(json.dumps({"serve": serve}), flush=True)

    timings = timing_phase(m)
    print(json.dumps({"timings": timings}), flush=True)
    sources = {  # name: (source, replaces, index of the main-path shape)
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:31", 2),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:101",
                            1),
        "moe_gather": ("src/repro_torch/csrc/moe_dispatch.cu",
                       "src/repro/kernels/moe_dispatch/kernel.py:51", 1),
        "ssd_intra": ("src/repro_torch/csrc/ssm_scan.cu",
                      "src/repro/kernels/ssm_scan/kernel.py:60", 0)}
    paths = [p for p in serve if isinstance(serve[p], dict)
             and "launches" in serve[p]]
    kernels = []
    for name, (source, replaces, main_shape) in sources.items():
        t = timings[name][main_shape]
        by_path = {p: serve[p]["launches"][name] for p in paths}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name],
            "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "call_ms": t["call_ms"]})
        if name == "flash_attention":
            routes = m["fa_ops"].ROUTES
            kernels[-1]["routes"] = {str(dt).replace("torch.", ""): r
                                     for dt, r in routes.items()}
            kernels[-1]["launches_by_route"] = {
                r: sum(serve[p]["flash_launches_by_route"][r] for p in paths)
                for r in routes.values()}
        _check(kernels[-1]["launches"] > 0, f"{name}: no launch on a path")
    print(f"[done] {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
