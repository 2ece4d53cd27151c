#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and a checkout of the repository around this file;
without either it exits non-zero and prints no result.  Imports nothing
of JAX and nothing of the ``repro`` package.  In order:

1. builds both CUDA kernels (RMSNorm, flash-attention forward) from
   ``src/repro_torch/csrc/``, one ``nvcc`` per source, in parallel;
2. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (bf16 and fp32), and a reduced two-layer
   model's fp32 prefill on the card (kernels) against the same model on
   the CPU (plain versions);
3. serves ``phi3-mini-3.8b`` at full width in bf16 with random weights
   from a seeded generator: (a) chunked prefill, 4 requests on 2 slots
   behind a 64-token shared prefix, so the prefix cache hits; (b) legacy
   bucketed prefill, 2 requests.  Each path runs with the kernels'
   launch counts set to 0 just before it and read just after;
4. compares the first-token logits of the two prefill paths on one
   prompt, then times each kernel, its plain version and the PyTorch
   library call with CUDA events: device time per call (``ms``, from
   CUDA-graph replays) and time per eager call (``call_ms``, host
   included).

It prints a ``{"serve": ...}`` line, a ``{"timings": ...}`` line, one
``{"kernels": [...]}`` line, the card's name and power limit, and ends
with ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""
from __future__ import annotations

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
ARCH = "phi3-mini-3.8b"
SEED = 0


def _imports():
    """The port's modules this script uses (import-hygiene tests call
    this: none of them may pull in JAX or ``repro``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine
    return dict(torch=torch, F=F, bridge=bridge, get_config=get_config,
                reduced_config=reduced_config, build=build, fa_ops=fa_ops,
                attention_ref=attention_ref, rms_ops=rms_ops,
                rmsnorm_ref=rmsnorm_ref, api=api, Engine=Engine)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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
    """Device and per-call times of a kernel, its plain version and the
    library call computing the same function."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = _device_ms(torch, fn)
        out[f"{key}call_ms"] = _time_ms(torch, fn)
    return out


def _max_err(torch, got, want, tol: float, what: str) -> float:
    g, w = got.float(), want.float()
    _check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    _check(not bool(bad.any()),
           f"{what}: max error {float(err.max())} above tolerance {tol}")
    return float(err.max())


def kernel_phase(m) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    torch = m["torch"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        for rows in (4, 128, 256):
            x = torch.randn(rows, 3072, generator=g, device="cuda").to(dt)
            s = torch.randn(3072, generator=g, device="cuda").to(dt)
            got = m["rms_ops"].rmsnorm_cuda(x, s)
            torch.cuda.synchronize()
            e = _max_err(torch, got, m["rmsnorm_ref"](x, s), tol,
                         f"rmsnorm {dt} [{rows},3072]")
            errs["rmsnorm"] = max(errs["rmsnorm"], e)
    cases = [  # (S, H, KV, D, window)
        (64, 32, 32, 96, None), (256, 32, 32, 96, None),
        (256, 32, 8, 96, None), (256, 32, 32, 96, 64)]
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
                         f"flash {dt} S={S} H={H} KV={KV} window={w}")
            errs["flash_attention"] = max(errs["flash_attention"], e)
    return errs


def reduced_model_phase(m) -> float:
    """A reduced fp32 model's prefill logits: card (kernels) vs CPU
    (plain versions), same weights."""
    torch, api, bridge = m["torch"], m["api"], m["bridge"]
    cfg = m["reduced_config"](ARCH).replace(num_layers=2, dtype="float32")
    cpu = api.build_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    gpu = bridge.from_numpy(bridge.to_numpy(cpu), cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(SEED))
    want, _, _ = api.forward(cpu, {"tokens": toks}, cfg, mode="prefill")
    before = m["fa_ops"].launches
    got, _, _ = api.forward(gpu, {"tokens": toks}, cfg, mode="prefill")
    _check(m["fa_ops"].launches == before + cfg.num_layers,
           "reduced prefill did not launch the flash kernel per layer")
    return _max_err(torch, got.cpu(), want, 1e-3, "reduced fp32 prefill")


def _serve(m, cfg, params, prompts, max_new, **kw) -> dict:
    """One engine run with the launch counts zeroed just before it."""
    torch = m["torch"]
    eng = m["Engine"](cfg, params, n_slots=2, max_len=256, eos_id=-1,
                      prefill_chunk=32, **kw)
    m["rms_ops"].launches = 0
    m["fa_ops"].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": m["rms_ops"].launches,
                "flash_attention": m["fa_ops"].launches}
    res = eng.results()
    for r in rids:
        _check(len(res[r]) == max_new + 1,
               f"request {r}: {len(res[r])} tokens, want {max_new + 1}")
        _check(eng.requests[r].finish_reason == "max_new",
               f"request {r} finished {eng.requests[r].finish_reason}")
    snap = eng.metrics_snapshot()
    tokens = sum(len(res[r]) for r in rids)
    return {"mode": eng.prefill_mode, "requests": len(rids),
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s_mean": snap["serving.ttft_s"]["mean"],
            "ttft_s_max": snap["serving.ttft_s"]["max"],
            "prefix_cache_hits": snap.get(
                "serving.prefix_cache.hits", {}).get("value", 0),
            "prefills": snap["serving.prefills"]["value"],
            "decode_ticks": snap["serving.decode_ticks"]["value"],
            "launches": launches}


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


def timing_phase(m) -> dict:
    """Kernel, plain version and library call at the main path's shapes
    (hot L2: the path's caller has just written these inputs)."""
    torch, F = m["torch"], m["F"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {"rmsnorm": [], "flash_attention": []}
    bf = torch.bfloat16
    for rows in (2, 64, 128):      # decode (2 slots), chunk (2 x 32), legacy
        x = torch.randn(rows, 3072, generator=g, device="cuda").to(bf)
        s = torch.randn(3072, generator=g, device="cuda").to(bf)
        nbytes = 2 * (2 * rows * 3072 + 3072)
        flops = 4 * rows * 3072
        out["rmsnorm"].append({
            "shape": [rows, 3072], "dtype": "bfloat16",
            **_times(torch, lambda: m["rms_ops"].rmsnorm_cuda(x, s),
                     lambda: m["rmsnorm_ref"](x, s),
                     lambda: F.rms_norm(x, (3072,), s, 1e-5)),
            "bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / FP32_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS else "operations")})
    for S in (64, 128):            # legacy prefill buckets of this run
        H, D = 32, 96
        q = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        k = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        v = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2                    # causal (q, k) pairs
        flops = 4 * D * pairs * H
        nbytes = 2 * 4 * S * H * D
        out["flash_attention"].append({
            "shape": [1, S, H, D], "dtype": "bfloat16", "causal": True,
            **_times(torch,
                     lambda: m["fa_ops"].flash_attention_cuda(
                         q, k, v, causal=True),
                     lambda: m["attention_ref"](q, k, v, causal=True),
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True)),
            "bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / BF16_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOPS else "operations")})
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
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    reports = m["build"].build()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {regs}", file=sys.stderr)
    print(f"[build] both kernels in {time.perf_counter() - t0:.1f}s",
          flush=True)

    errs = kernel_phase(m)
    print(f"[kernels] max abs error vs plain: {errs}", flush=True)
    red_err = reduced_model_phase(m)
    print(f"[kernels] reduced fp32 prefill, card vs cpu: {red_err}",
          flush=True)

    cfg = m["get_config"](ARCH)
    t0 = time.perf_counter()
    params = m["api"].build_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {ARCH} full width, {cfg.num_layers} layers, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B params "
          f"bf16, init {time.perf_counter() - t0:.3f}s", flush=True)

    import numpy as np
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, 64).tolist()
    prompts_a = [shared + rng.integers(0, cfg.vocab_size,
                                       int(rng.integers(2, 12))).tolist()
                 for _ in range(4)]
    prompts_b = [rng.integers(0, cfg.vocab_size,
                              int(rng.integers(40, 100))).tolist()
                 for _ in range(2)]
    serve_a = _serve(m, cfg, params, prompts_a, 8, prefill_mode="chunked",
                     prefix_cache_entries=32)
    serve_b = _serve(m, cfg, params, prompts_b, 8, prefill_mode="legacy")
    _check(serve_a["prefix_cache_hits"] > 0, "no prefix-cache hit in (a)")
    _check(serve_a["launches"]["rmsnorm"] > 0, "no rmsnorm launch in (a)")
    _check(serve_b["launches"]["rmsnorm"] > 0, "no rmsnorm launch in (b)")
    _check(serve_b["launches"]["flash_attention"] > 0,
           "no flash-attention launch in (b)")

    chunked, legacy = first_token_logits(m, cfg, params, prompts_a[0])
    _check(bool(torch.isfinite(chunked).all()
                and torch.isfinite(legacy).all()),
           "non-finite first-token logits")
    cos = float(torch.nn.functional.cosine_similarity(chunked, legacy, dim=0))
    # the two paths do the same bf16 math with fp32 attention; they
    # differ only in where sums are rounded (chunk attention over the
    # cache vs the flash kernel's tiles), a few bf16 ulps per layer
    _check(cos >= 0.99, f"chunked vs legacy first-token cosine {cos}")
    same_argmax = int(chunked[:cfg.vocab_size].argmax()) == int(
        legacy[:cfg.vocab_size].argmax())
    print(json.dumps({"serve": {"chunked": serve_a, "legacy": serve_b,
                                "first_token_cosine": cos,
                                "first_token_same_argmax": same_argmax}}),
          flush=True)

    timings = timing_phase(m)
    print(json.dumps({"timings": timings}), flush=True)
    sources = {"rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:31", 2),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:101", 1)}
    kernels = []
    for name, (source, replaces, main_shape) in sources.items():
        t = timings[name][main_shape]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serve_a["launches"][name]
            + serve_b["launches"][name],
            "launches_by_path": {"chunked": serve_a["launches"][name],
                                 "legacy": serve_b["launches"][name]},
            "max_abs_err": errs[name], "shape": t["shape"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "call_ms": t["call_ms"]})
    print(f"[done] {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
