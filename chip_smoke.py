#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and a checkout of the repository around this file;
without either it exits non-zero and prints no result.  Imports nothing
of JAX and nothing of the ``repro`` package.  In order:

1. builds the five CUDA sources (RMSNorm with its fused residual-add
   form, flash-attention forward, the MoE dispatch, SSD intra-chunk, the
   SIMT machine's cycle loop) from ``src/repro_torch/csrc/``, one
   ``nvcc`` per source, in parallel;
2. drives the Vortex SIMT machine: the kernel (one launch per machine
   run) against the plain PyTorch loop on the card, every State field
   and counter bit-equal (vecadd and nn at 8w8t, gaussian at 4w16t at
   the Fig 9 sizes, a small bfs, and the edge-case programs of
   ``runtime/kernels_src/edge_cases.py``); then the Fig 9 grid (42
   cells, ``benchmarks/fig9_rodinia.py``'s settings) through the Rodinia
   benches, each cell passing its numpy oracle and matching the
   committed ``benchmarks/baselines/BENCH_fig9_rodinia.json`` in its 16
   counters and cycles, each cell's kernel time under the profiler; the
   paper's four claims (``tests/test_paper_claims.py``) on the port's
   own numbers, the Fig 8 rows and Fig 10's best configuration per
   bench; it prints a ``{"simt": ...}`` line;
3. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes (the MoE dispatch bit-exact in its buffer,
   slots and counts, also at a 4096-token prefill, with and without
   capacity drops; the fused norm's sum bit-exact; flash in bf16 on its
   wgmma/TMA route and in fp32 on its FMA route, also at zamba2's
   head_dim 112, and in bf16 at long prefills of 4096 tokens and a
   ragged S = 200; SSD at chunks of 1, 64, 65, 128 and 256 tokens, at
   16 chunks of 256 and with steep decay, and its worst error /
   tolerance against an fp64 plain version over three seeds), and
   reduced fp32 phi3, deepseek-moe-16b and zamba2-7b prefills on the
   card (kernels) against the same models on the CPU (plain versions);
4. serves three models at full published width in bf16, one on the
   card at a time, with random weights from a seeded generator:
   ``phi3-mini-3.8b`` (a) chunked prefill, 4 requests on 2 slots behind
   a 64-token shared prefix, so the prefix cache hits, (a') the same on
   the paged KV layout (pages of 32 tokens), which must give (a)'s
   tokens, share prefix pages and copy none, then (a) again (warm, as
   (a') is), (b) legacy bucketed prefill, 2 requests, (b-obs) (b) again
   with the observability plane on (tracer, flight recorder, kernel
   timing, an HTTP server scraped mid-run), which must give (b)'s
   tokens and count each kernel's launches as its wrapper does, then
   (b) again (warm), and (chaos) (a) on the paged layout under the
   seeded fault plan of ``--chaos-seed 1234``, where every request
   must finish with a known reason and the flight dump written under
   ``build/`` must validate; ``deepseek-moe-16b`` (c) chunked, as (a),
   (c') paged, as (a'), then (c) again, (d) legacy, as (b);
   ``zamba2-7b`` (e) legacy, prompts of exactly 64 and 128 tokens, so
   no pad enters the recurrent state, and its engine must refuse the
   paged layout.
   Each path runs with every kernel's launch count set to 0 just before
   it and read just after (flash's per route too: bf16 serving must
   run it on the wgmma route only);
5. checks consistency: phi3's chunked and legacy first-token logits
   (cosine >= 0.99); zamba2's prefill(64) + one decode step against the
   last logits of prefill(65) (cosine >= 0.99); deepseek's chunked vs
   legacy first-token cosine is printed only (see there); profiles
   one prefill and one decode forward of each model (wall vs device
   time, kernel count, host syncs, the kernels with most device time);
   profiles one deepseek MoE layer, which must launch one dispatch
   kernel and run no bincount, argsort, index_put or host sync; and
   times the paged layout's page gather and scatter of one decode tick
   on phi3's and deepseek's pools;
6. times each kernel, its plain version and the PyTorch library call
   where one computes the same function, with CUDA events: device time
   per call (``ms``, from CUDA-graph replays; for the plain MoE
   dispatch, which syncs with the host and cannot be captured, the sum
   of its kernels' times under the profiler) and time per eager call
   (``call_ms``, host included); flash also at the long prefills; SSD
   also at 16 chunks of 256.

It prints a ``{"simt": ...}`` line, a ``{"serve": ...}`` line, a
``{"timings": ...}`` line, one ``{"kernels": [...]}`` line, the card's
name and power limit, and ends with ``{"ok": true, "device": {...}}``.
Any failed check raises.
"""
from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
TF32X3_FLOPS = 495e12 / 3          # fp32 products as 3 TF32 tensor-core passes
PHI3, DEEPSEEK, ZAMBA = "phi3-mini-3.8b", "deepseek-moe-16b", "zamba2-7b"
KERNELS = ("rmsnorm", "add_rmsnorm", "flash_attention", "moe_dispatch",
           "ssd_intra")
OUR_KERNELS = {  # kernel: its CUDA functions' names, as the profiler shows
    "rmsnorm": r"(?<!add_)rmsnorm_kernel", "add_rmsnorm": r"add_rmsnorm_kernel",
    "flash_attention": r"flash_fwd_", "moe_dispatch": r"moe_dispatch_kernel",
    "ssd_intra": r"ssd_intra_kernel"}
NORM_WIDTHS = (2048, 3072, 3584, 7168)  # deepseek, phi3, zamba2, its inner norm
SEED = 0


def _imports():
    """The port's modules this script uses (import-hygiene tests call
    this: none of them may pull in JAX or ``repro``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import bridge, faults, obs
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.simt import machine, power
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_dispatch import ops as dispatch_ops
    from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.simt_machine import ops as simt_ops
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_scan.ref import ssd_intra_ref
    from repro_torch.models import api
    from repro_torch.models.moe import moe_capacity, moe_forward
    from repro_torch.obs import demo  # noqa: F401  (its imports, checked)
    from repro_torch.runtime.asm import assemble
    from repro_torch.runtime.kernels_src import edge_cases, rodinia
    from repro_torch.serving import kv_pool
    from repro_torch.serving.engine import Engine
    return dict(np=np, torch=torch, F=F, bridge=bridge, obs=obs,
                faults=faults, kv_pool=kv_pool,
                get_config=get_config, reduced_config=reduced_config,
                build=build, fa_ops=fa_ops, attention_ref=attention_ref,
                dispatch_ops=dispatch_ops, moe_dispatch_ref=moe_dispatch_ref,
                rms_ops=rms_ops, rmsnorm_ref=rmsnorm_ref, ssd_ops=ssd_ops,
                ssd_intra_ref=ssd_intra_ref, api=api, Engine=Engine,
                moe_capacity=moe_capacity, moe_forward=moe_forward,
                machine=machine, power=power, simt_ops=simt_ops,
                assemble=assemble, edge_cases=edge_cases, rodinia=rodinia)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _zero_counts(m) -> None:
    for mod in ("rms_ops", "fa_ops", "dispatch_ops", "ssd_ops"):
        m[mod].launches = 0
    for by in (m["rms_ops"].launches_by_form, m["fa_ops"].launches_by_route):
        for key in by:
            by[key] = 0


def _counts(m) -> dict:
    """Launches of each kernel of KERNELS (the RMSNorm wrapper counts
    its plain and fused forms apart)."""
    return {**m["rms_ops"].launches_by_form,
            "flash_attention": m["fa_ops"].launches,
            "moe_dispatch": m["dispatch_ops"].launches,
            "ssd_intra": m["ssd_ops"].launches}


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


def _profiled_ms(torch, fn, reps: int = 20) -> float:
    """Device time per call of an eager `fn` that a CUDA graph cannot
    capture (it syncs with the host): the sum of the self device times
    of its kernels and copies under ``torch.profiler`` over `reps`
    calls, after a warm-up; the gaps between them are not counted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev / 1e3 / reps


def _times(torch, kernel, plain, library, plain_syncs=False) -> dict:
    """Device and per-call times of a kernel, its plain version and,
    where one exists, the library call computing the same function.
    `plain_syncs`: the plain version syncs with the host, so its device
    time comes from the profiler, not from a graph."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            out[f"{key}ms"] = out[f"{key}call_ms"] = None
            continue
        out[f"{key}ms"] = (_profiled_ms(torch, fn)
                           if key == "plain_" and plain_syncs
                           else _device_ms(torch, fn))
        out[f"{key}call_ms"] = _time_ms(torch, fn)
    return out


def _bound(nbytes: float, flops: float, peak: float,
           tc_flops: float = 0.0) -> dict:
    """`flops` at `peak`; of them, `tc_flops` are products that run on
    the tensor cores in 3xTF32 and count at that rate instead."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (flops - tc_flops) / peak + tc_flops / TF32X3_FLOPS
    return {"bytes": nbytes, "flops": flops, "tc_flops": tc_flops,
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

def dispatch_inputs(torch, g, T, d, E, k, dtype):
    """x [T, d] and eidx [T, k] int64: the top-k of skewed random router
    scores (low expert ids are popular and overflow a tight capacity),
    from generator `g` on the card."""
    x = torch.randn(T, d, generator=g, device="cuda").to(dtype)
    scores = (torch.rand(T, E, generator=g, device="cuda")
              + torch.linspace(1, 0, E, device="cuda"))
    return x, torch.topk(scores, k, dim=-1).indices


def ssd_inputs(torch, g, nc, Q, H=112, P=64, N=64, rate=0.1):
    """zamba2's widths; cum steps are -rate * U(0, 1)."""
    cum = torch.cumsum(-rate * torch.rand(1, nc, Q, H, generator=g,
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
        for rows in (2, 64, 128, 256):
            for d in NORM_WIDTHS:
                x, h = (torch.randn(rows, d, generator=g, device="cuda")
                        .to(dt) for _ in range(2))
                w = torch.randn(d, generator=g, device="cuda").to(dt)
                got = m["rms_ops"].rmsnorm_cuda(x, w)
                s, y = m["rms_ops"].add_rmsnorm_cuda(x, h, w)
                torch.cuda.synchronize()
                e = _max_err(torch, got, m["rmsnorm_ref"](x, w), tol,
                             f"rmsnorm {dt} [{rows},{d}]")
                errs["rmsnorm"] = max(errs["rmsnorm"], e)
                _check(torch.equal(s, x + h),
                       f"add_rmsnorm {dt} [{rows},{d}]: sum not bit-exact")
                e = _max_err(torch, y, m["rmsnorm_ref"](x + h, w), tol,
                             f"add_rmsnorm {dt} [{rows},{d}]")
                errs["add_rmsnorm"] = max(errs["add_rmsnorm"], e)
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
    # the MoE dispatch at deepseek's widths (E = 64, top-6, d = 2048):
    # decode, chunk and bucket token counts and a 4096-token prefill
    # (N = 24576 pairs); C tight (one average expert's load, so popular
    # experts drop pairs), the model's capacity, and ample (C = T: no
    # expert can overflow)
    cfg = m["get_config"](DEEPSEEK)
    drops = {}
    for dt in (torch.bfloat16, torch.float32):
        for T in (1, 2, 64, 128, 4096):
            x, eidx = dispatch_inputs(torch, g, T, 2048, 64, 6, dt)
            for kind, C in (("tight", max(1, T * 6 // 64)),
                            ("model", m["moe_capacity"](T, cfg)),
                            ("ample", T)):
                got = m["dispatch_ops"].moe_dispatch_cuda(eidx, x, 64, C)
                torch.cuda.synchronize()
                want = m["moe_dispatch_ref"](eidx, x, 64, C)
                for name, a, b in zip(("buf", "dest_tk", "counts"), got,
                                      want):
                    _check(a.dtype == b.dtype and torch.equal(a, b),
                           f"moe_dispatch {dt} T={T} C={C}: {name} not "
                           f"bit-exact")
                drops[f"{T}/{kind}"] = int((got[1] == 64 * C).sum())
                del got, want
            del x, eidx
    _check(all(drops[f"{T}/ample"] == 0 for T in (1, 2, 64, 128, 4096))
           and all(drops[f"{T}/tight"] > 0 for T in (64, 128, 4096)),
           f"moe_dispatch: dropped pairs {drops}")
    print(f"[kernels] moe_dispatch dropped pairs (last dtype): {drops}",
          flush=True)
    # SSD at zamba2's prefill chunks, one-token chunks, its 4096-token
    # context (16 chunks of 256), and steep decay (cum steps to -10: exp
    # past the diagonal overflows, so a mask applied after exp gives NaN)
    for nc, Q, rate in ((1, 1, 0.1), (1, 64, 0.1), (1, 65, 0.1),
                        (1, 128, 0.1), (2, 256, 0.1), (16, 256, 0.1),
                        (1, 64, 10.0), (2, 256, 10.0)):
        args = ssd_inputs(torch, g, nc, Q, rate=rate)
        y, s = m["ssd_ops"].ssd_intra_cuda(*args)
        torch.cuda.synchronize()
        yr, sr = m["ssd_intra_ref"](*args)
        what = f"ssd nc={nc} Q={Q} rate={rate}"
        e = max(_max_err(torch, y, yr, 1e-4, f"{what} y"),
                _max_err(torch, s, sr, 1e-4, f"{what} S"))
        errs["ssd_intra"] = max(errs["ssd_intra"], e)
        if (nc, Q) == (16, 256):
            # worst |err| / tolerance of the kernel (3xTF32) and of one
            # TF32 pass: the plain version with its matmuls in TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            y1, s1 = m["ssd_intra_ref"](*args)
            torch.backends.cuda.matmul.allow_tf32 = False
            share = {name: max(float(((a - b).abs() / (1e-4 + 1e-4 * b.abs()))
                                     .max()) for a, b in pair)
                     for name, pair in (("3xtf32_kernel", ((y, yr), (s, sr))),
                                        ("tf32_plain", ((y1, yr), (s1, sr))))}
            print(f"[kernels] ssd [1,16,256,112,64,64] worst error / "
                  f"tolerance: {share}", flush=True)
            del y1, s1
        del args, y, s, yr, sr
    ssd_error_survey(m)
    return errs


def _share(torch, got, want) -> float:
    """Worst |got - want| / (1e-4 + 1e-4 |want|): the share of the SSD
    tolerance used."""
    return float(((got.double() - want).abs()
                  / (1e-4 + 1e-4 * want.abs())).max())


def _ssd_fp64(torch, cum, xdt, Bc, Cc):
    """The plain SSD (``ssd_intra_ref``'s math) in fp64."""
    cum, xdt, Bc, Cc = (t.double() for t in (cum, xdt, Bc, Cc))
    Q = cum.shape[2]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=cum.device))
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)
    M = torch.where(tri[None, None, :, :, None], CB[..., None] * decay,
                    torch.zeros((), dtype=torch.float64, device=cum.device))
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)
    return (torch.einsum("bnqkh,bnkhp->bnqhp", M, xdt),
            torch.einsum("bnkh,bnks,bnkhp->bnhsp", dec_end, Bc, xdt))


def ssd_error_survey(m) -> None:
    """Worst error / tolerance of the SSD kernel (y and S) and of the
    plain version in fp32, against the plain version in fp64, over seeds
    0-2, at 16 chunks of 256 and with steep decay; and at 16 x 256 with
    B and C, then xdt, on a grid of 1/8 in [-4, 4]: such values are
    exact in TF32, so C.B^T, then the products with xdt, lose nothing to
    3xTF32's dropped lo*lo' term."""
    torch = m["torch"]
    grid = lambda t: torch.clamp(torch.round(8 * t) / 8, -4, 4)  # noqa: E731
    out = {}
    for nc, Q, rate in ((16, 256, 0.1), (1, 64, 10.0), (2, 256, 10.0)):
        for seed in range(3):
            g = torch.Generator(device="cuda").manual_seed(seed)
            args = ssd_inputs(torch, g, nc, Q, rate=rate)
            variants = {"randn": args}
            if (nc, seed) == (16, 0):
                variants["BC_on_grid"] = (args[0], args[1], grid(args[2]),
                                          grid(args[3]))
                variants["xdt_on_grid"] = (args[0], grid(args[1]), args[2],
                                           args[3])
            for name, a in variants.items():
                y, s = m["ssd_ops"].ssd_intra_cuda(*a)
                yp, sp = m["ssd_intra_ref"](*a)
                yr, sr = _ssd_fp64(torch, *a)
                out[f"{nc}x{Q} rate={rate} seed={seed} {name}"] = {
                    "y": _share(torch, y, yr), "S": _share(torch, s, sr),
                    "plain_y": _share(torch, yp, yr),
                    "plain_S": _share(torch, sp, sr)}
                del y, s, yp, sp, yr, sr
            del args, variants
    print("[kernels] ssd worst error / tolerance against fp64: "
          + json.dumps(out), flush=True)


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
            groups = layers // cfg.attn_every
            # the first block's norm and each mixer's gated norm are
            # plain; every other norm takes the residual add in
            _check(n["ssd_intra"] == layers and n["flash_attention"]
                   == groups and n["rmsnorm"] == 1 + layers
                   and n["add_rmsnorm"] == layers + 2 * groups,
                   f"{arch}: launches {n} per prefill")
        else:
            _check(n["flash_attention"] == layers and n["rmsnorm"] == 1
                   and n["add_rmsnorm"] == 2 * layers,
                   f"{arch}: launches {n} per prefill")
        if cfg.is_moe:
            _check(n["moe_dispatch"] == layers - cfg.moe.first_k_dense,
                   f"{arch}: dispatch launches {n} per prefill")
        out[arch] = {"max_abs_err": _max_err(torch, got.cpu(), want, 1e-3,
                                             f"reduced fp32 {arch}"),
                     "launches": n}
    return out


FINISH_REASONS = {"eos", "max_new", "max_len", "timeout", "shed",
                  "degraded"}


def _serve(m, cfg, params, prompts, max_new, reasons=("max_new",),
           during=None, after=None, **kw) -> dict:
    """One engine run with every launch count zeroed and the peak
    memory reset just before it.  Every request must finish with one of
    `reasons` and `max_new + 1` tokens.  `during(eng)` runs after the
    first tick, `after(eng)` after the run; their results go under
    "during" and "after".  No engine outlives the call, so the next
    run's peak memory holds no pool of this one."""
    torch = m["torch"]
    gc.collect()                # a paged engine's prefix hook is a cycle
    eng = m["Engine"](cfg, params, n_slots=2, max_len=256, eos_id=-1,
                      prefill_chunk=32, **kw)
    _zero_counts(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    extra = {}
    if during is not None:
        eng.step()
        extra["during"] = during(eng)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(m)
    routes = dict(m["fa_ops"].launches_by_route)
    res = eng.results()
    for r in rids:
        why = eng.requests[r].finish_reason
        _check(why in reasons, f"request {r} finished {why!r}")
        _check(len(res[r]) == max_new + 1,
               f"request {r}: {len(res[r])} tokens, want {max_new + 1}")
    snap = eng.metrics_snapshot()
    tokens = sum(len(res[r]) for r in rids)
    out = {"arch": cfg.name, "mode": eng.prefill_mode,
           "kv_layout": eng.kv_layout,
           "requests": len(rids), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_s_mean": snap["serving.ttft_s"]["mean"],
           "ttft_s_max": snap["serving.ttft_s"]["max"],
           "prefix_cache_hits": snap.get(
               "serving.prefix_cache.hits", {}).get("value", 0),
           "prefills": snap["serving.prefills"]["value"],
           "decode_ticks": snap["serving.decode_ticks"]["value"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "out": [res[r] for r in rids],
           "reasons": [eng.requests[r].finish_reason for r in rids],
           "launches": launches, "flash_launches_by_route": routes}
    if eng.kv_layout == "paged":
        out["kv"] = {k.split(".")[-1]: snap.get(k, {}).get("value", 0)
                     for k in ("serving.kv.pages_shared",
                               "serving.kv.pages_copied",
                               "serving.kv.cow_splits",
                               "serving.kv.admit_blocked")}
    if after is not None:
        extra["after"] = after(eng)
    out.update(extra)
    return out


def serve_paged(m, cfg, params, prompts, contiguous) -> tuple:
    """(a') / (c'): the chunked run on the paged layout (pages of 32
    tokens); the tokens must equal the contiguous run's, prefix hits
    must share pages, and the page-aligned 64-token prefix must be
    copied never.  Then the contiguous run again, warm as the paged one
    is ((a) and (c) pay first calls), to compare the two layouts."""
    out = _serve(m, cfg, params, prompts, 8, prefill_mode="chunked",
                 prefix_cache_entries=32, kv_layout="paged", kv_page_size=32)
    _check(out["out"] == contiguous["out"],
           f"{cfg.name} paged tokens {out['out']} != contiguous "
           f"{contiguous['out']}")
    _check(out["kv"]["pages_shared"] > 0 and out["kv"]["pages_copied"] == 0,
           f"{cfg.name} paged kv counters {out['kv']}")
    again = _serve(m, cfg, params, prompts, 8, prefill_mode="chunked",
                   prefix_cache_entries=32)
    _check(again["out"] == contiguous["out"], "chunked tokens changed")
    print(f"[serve] {cfg.name} paged: pages_shared "
          f"{out['kv']['pages_shared']}, pages_copied "
          f"{out['kv']['pages_copied']}; tokens/s {out['tokens_per_s']:.2f}"
          f" paged vs {again['tokens_per_s']:.2f} contiguous (warm)",
          flush=True)
    return out, again


def serve_obs(m, cfg, params, prompts, plain) -> dict:
    """(b-obs): the legacy run with the whole observability plane on:
    tracer, flight recorder (mirroring the tracer), kernel timing, and
    an HTTP server on an ephemeral port scraped once after the first
    tick.  Tokens must equal the plain run's, the trace must hold at
    least 3 span names, and ``kernels.<name>.launches`` must equal each
    kernel wrapper's own count.  Then (b-again): the plain run once
    more, warm as this one is ((b) pays first calls), for the wall cost
    of the plane."""
    import urllib.request
    obs, torch = m["obs"], m["torch"]
    obs.metrics.reset()
    obs.tracer.clear()
    obs.flight.clear()
    obs.enable_tracing()
    obs.flight.enable()
    obs.flight.attach_tracer(obs.tracer)
    obs.enable_kernel_timing()
    server = None

    def scrape(eng):
        nonlocal server
        server = obs.ObsServer(port=0, registries=[eng.metrics, obs.metrics],
                               health=eng.liveness,
                               requests=eng.debug_requests,
                               flight=obs.flight)
        port = server.start()
        got = {}
        for path in ("/metrics", "/healthz", "/debug/requests"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as r:
                got[path] = (r.status, r.read().decode())
        _check(got["/metrics"][0] == 200
               and got["/metrics"][1].endswith("# EOF\n"),
               f"/metrics scrape {got['/metrics'][0]}")
        _check(got["/healthz"][0] == 200, f"/healthz {got['/healthz']}")
        return {p: c for p, (c, _) in got.items()}

    try:
        out = _serve(m, cfg, params, prompts, 8, prefill_mode="legacy",
                     during=scrape)
    finally:
        if server is not None:
            server.stop()
        obs.disable_kernel_timing()
        obs.disable_tracing()
        obs.flight.disable()
    events = obs.tracer.drain()
    names = sorted({e["name"] for e in events if e.get("ph") == "X"})
    kernels = {k.split(".")[1]: v["value"]
               for k, v in obs.metrics.snapshot().items()
               if k.endswith(".launches")}
    timed = {k.split(".")[1]: v["count"]
             for k, v in obs.metrics.snapshot().items()
             if k.endswith(".time_s")}
    _check(out["out"] == plain["out"],
           f"obs-on tokens {out['out']} != plain {plain['out']}")
    _check(len(names) >= 3, f"trace span names {names}")
    ops = {k: v for k, v in out["launches"].items() if v}
    _check(kernels == ops and timed == ops,
           f"kernels.<name>.launches {kernels} (timed {timed}) != the "
           f"wrappers' counts {ops}")
    flights = [e["kind"] for e in obs.flight.snapshot()]
    out.update(span_names=names, trace_events=len(events),
               kernel_launches_counted=kernels,
               kernel_time_s={k: v["sum"] for k, v in
                              obs.metrics.snapshot().items()
                              if k.endswith(".time_s")},
               flight_events=len(flights))
    obs.metrics.reset()
    obs.flight.clear()
    again = _serve(m, cfg, params, prompts, 8, prefill_mode="legacy")
    _check(again["out"] == plain["out"], "legacy tokens changed")
    out["wall_vs_plain_again"] = out["wall_s"] / again["wall_s"]
    print(f"[serve] {cfg.name} legacy with the obs plane: wall "
          f"{out['wall_s']:.3f}s vs {plain['wall_s']:.3f}s (b), "
          f"{again['wall_s']:.3f}s (b) again; {len(names)} span names, "
          f"kernels {kernels}", flush=True)
    return out, again


def serve_chaos(m, cfg, params, prompts) -> dict:
    """(chaos): the paged chunked run under ``faults.serving_plan(1234)``
    (NaN / Inf logits, slow decode ticks, transient step crashes) with
    the flight recorder on: every request finishes with a reason of the
    JAX engine's set, and the dump written to build/ validates."""
    faults, obs = m["faults"], m["obs"]
    inj = faults.FaultInjector(faults.serving_plan(1234))

    def dump(eng):
        snap = eng.metrics_snapshot()   # not the engine: it is freed after
        obs.flight.add_metrics_source(lambda: snap)
        obs.flight.add_metrics_source(inj.metrics)
        return obs.flight.dump(str(ROOT / "build"), reason="chaos-run-end")

    obs.flight.clear()
    obs.flight.enable()
    try:
        out = _serve(m, cfg, params, prompts, 8,
                     reasons=tuple(FINISH_REASONS), after=dump,
                     prefill_mode="chunked", prefix_cache_entries=32,
                     kv_layout="paged", kv_page_size=32, faults=inj)
    finally:
        obs.flight.disable()
    path = out.pop("after")
    doc = json.loads(Path(path).read_text())
    obs.validate_flight(doc)
    snap = next(v for v in doc["metrics"].values()
                if "serving.tokens" in v)
    kinds = [e["kind"] for e in doc["events"]]
    out.update(
        watchdog_retries=snap.get("serving.watchdog.retries",
                                  {}).get("value", 0),
        nonfinite_logit_rows=snap.get("serving.decode.nonfinite_logit_rows",
                                      {}).get("value", 0),
        faults_injected={k: v["value"]
                         for k, v in inj.metrics.snapshot().items()},
        faults_remaining=inj.remaining(),
        flight_dump=str(Path(path).relative_to(ROOT)),
        flight_events=len(kinds),
        finishes=kinds.count("serving.finish"))
    _check(out["finishes"] == len(prompts),
           f"flight dump holds {out['finishes']} finishes")
    obs.flight.clear()
    print(f"[serve] {cfg.name} chaos: reasons {out['reasons']}, "
          f"serving.watchdog.retries {out['watchdog_retries']}, "
          f"serving.decode.nonfinite_logit_rows "
          f"{out['nonfinite_logit_rows']}, flight dump {path}", flush=True)
    return out


def paged_copy_profile(m, cfg, params) -> dict:
    """One decode tick's page traffic on a 2-slot paged engine's pool
    (max_len 256, pages of 32): the gather of the whole [2, 256] view
    through a read table of 16 distinct pages, and the scatter of one
    dirty page per slot.  Device ms from the profiler (the index copy
    from the host keeps them out of a CUDA graph), per-call ms with the
    host; bound: the view read and written once (gather), the dirty
    pages read and written once (scatter)."""
    torch, np, kvp = m["torch"], m["np"], m["kv_pool"]
    eng = m["Engine"](cfg, params, n_slots=2, max_len=256,
                      prefill_chunk=32, kv_layout="paged", kv_page_size=32)
    kv = eng._kv
    n, pps, ps = eng.n_slots, kv.pages_per_slot, kv.page_size
    table = np.arange(n * pps, dtype=np.int32).reshape(n, pps)
    mask = np.zeros((n, pps), bool)
    mask[:, 2] = True
    view = kvp.gather_pages(eng.caches, table, n, pps, ps)
    nbytes = sum(t.numel() * t.element_size()
                 for st in view.values() for t in st.values())
    out = {}
    for name, fn, moved in (
            ("gather", lambda: kvp.gather_pages(eng.caches, table, n, pps,
                                                ps), 2 * nbytes),
            ("scatter", lambda: kvp.scatter_pages(
                eng.caches, view, table, mask, n, pps, ps),
             2 * nbytes * int(mask.sum()) // mask.size)):
        out[name] = {"ms": _profiled_ms(torch, fn),
                     "call_ms": _time_ms(torch, fn),
                     "bound_ms": 1e3 * moved / HBM_BYTES_PER_S}
    out["view_gb"] = nbytes / 1e9
    del eng, view
    return out


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
    share, the number of kernels, the host syncs (device-to-host reads:
    ``aten::_local_scalar_dense`` calls, and ``cudaStreamSynchronize``),
    the five kernels with the most device time, and the device ms and
    launches of each hand-written kernel."""
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
        events = prof.key_averages()
        kern = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        ours = {k: [sum(e.self_device_time_total for e in kern
                        if re.search(pat, e.key)) / 1e3,
                    sum(e.count for e in kern if re.search(pat, e.key))]
                for k, pat in OUR_KERNELS.items()}
        syncs = {key: sum(e.count for e in events if e.key == key)
                 for key in ("aten::_local_scalar_dense",
                             "cudaStreamSynchronize")}
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "busy_share": dev / wall,
                     "kernels": sum(e.count for e in kern),
                     "host_syncs": syncs,
                     "top": [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in top],
                     "ours": ours}
    return out


def _profile_ops(torch, fn) -> tuple:
    """Kernels launched by one call of `fn` under the profiler (after a
    warm-up call), and the count of each op that sorts, counts, scatters
    or reads the device back to the host."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = {e.key: e.count for e in events
           if re.match(r"aten::(bincount|argsort|index_put|"
                       r"_local_scalar_dense)", e.key)}
    kernels = sum(e.count for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0)
    return kernels, ops


def moe_layer_profile(m, cfg, params) -> dict:
    """One MoE layer of the full-width model (``moe_forward`` on
    [1, 64, d] and [2, 1, d] bf16 inputs) under the profiler: it must
    launch exactly one dispatch kernel, and run no bincount, argsort,
    index_put or device-to-host read.  Beside it, the plain dispatch on
    the same routing, as the layer ran it before the kernel took it in."""
    torch = m["torch"]
    stage = params["stage1"]
    lp = stage.layer(stage.n - 1)["moe"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    out = {}
    for B, S in ((1, 64), (2, 1)):
        x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda").to(
            torch.bfloat16)
        _zero_counts(m)
        kernels, ops = _profile_ops(
            torch, lambda: m["moe_forward"](lp, x, cfg))
        n = _counts(m)["moe_dispatch"]
        _check(n == 2 and not ops,      # the warm-up call and the profiled
               f"moe layer [{B},{S}]: {n} dispatch launches, ops {ops}")
        xf = x.reshape(B * S, -1)
        eidx = torch.topk(xf.float() @ lp["router"], k, dim=-1).indices
        C = m["moe_capacity"](B * S, cfg)
        plain_kernels, plain_ops = _profile_ops(
            torch, lambda: m["moe_dispatch_ref"](eidx, xf, E, C))
        out[f"{B}x{S}"] = {"kernels": kernels, "dispatch_launches": n // 2,
                           "plain_dispatch_kernels": plain_kernels,
                           "plain_dispatch_ops": plain_ops}
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
    out["phi3_chunked_paged"], out["phi3_chunked_again"] = serve_paged(
        m, cfg, params, pa, out["phi3_chunked"])
    out["phi3_legacy"] = _serve(m, cfg, params, pb, 8, prefill_mode="legacy")
    out["phi3_legacy_obs"], out["phi3_legacy_again"] = serve_obs(
        m, cfg, params, pb, out["phi3_legacy"])
    out["phi3_chaos"] = serve_chaos(m, cfg, params, pa)
    out["phi3_paged_copies"] = paged_copy_profile(m, cfg, params)
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
    out["deepseek_chunked_paged"], out["deepseek_chunked_again"] = \
        serve_paged(m, cfg, params, pa, out["deepseek_chunked"])
    out["deepseek_legacy"] = _serve(m, cfg, params, pb, 8,
                                    prefill_mode="legacy")
    out["deepseek_paged_copies"] = paged_copy_profile(m, cfg, params)
    chunked, legacy = first_token_logits(m, cfg, params, pa[0])
    # printed, not asserted: MoE capacity drops couple a token's output
    # to the other tokens of its batch (the other chunk positions and
    # pads here, the 128-token bucket there: C = 8 vs 16), so the two
    # paths route different token sets and need not agree
    out["deepseek_first_token_cosine"] = _cosine(torch, chunked, legacy)
    out["deepseek_profile"] = step_profile(m, cfg, params)
    out["deepseek_moe_layer"] = moe_layer_profile(m, cfg, params)
    del params
    _free(torch)

    # hybrid: zamba2-7b, prompts of exactly one bucket (64, 128 tokens)
    cfg, params = _build_model(m, ZAMBA)
    pz = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (64, 128)]
    out["zamba_legacy"] = _serve(m, cfg, params, pz, 8,
                                 prefill_mode="legacy")
    # zamba2's SSM and conv states have no sequence axis to page, and it
    # prefills legacy only: its engine refuses the paged layout, as the
    # JAX engine does
    try:
        m["Engine"](cfg, params, n_slots=2, max_len=256, kv_layout="paged")
    except ValueError as e:
        out["zamba_paged_refused"] = str(e)
    else:
        raise AssertionError("zamba2 accepted kv_layout='paged'")
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
    norms = ("rmsnorm", "add_rmsnorm")
    expect = {"phi3_chunked": norms, "phi3_chunked_paged": norms,
              "phi3_chunked_again": norms,
              "phi3_legacy": norms + ("flash_attention",),
              "phi3_legacy_obs": norms + ("flash_attention",),
              "phi3_legacy_again": norms + ("flash_attention",),
              "phi3_chaos": norms,
              "deepseek_chunked": norms + ("moe_dispatch",),
              "deepseek_chunked_paged": norms + ("moe_dispatch",),
              "deepseek_chunked_again": norms + ("moe_dispatch",),
              "deepseek_legacy": norms + ("flash_attention", "moe_dispatch"),
              "zamba_legacy": norms + ("flash_attention", "ssd_intra")}
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
    # the fused form at phi3's shapes and deepseek's and zamba2's bucket;
    # the library yardstick is torch.add then F.rms_norm (both kernels'
    # device times, captured in one graph)
    for rows, d in ((2, 3072), (64, 3072), (128, 3072), (128, 2048),
                    (128, 3584)):
        x, h = (torch.randn(rows, d, generator=g, device="cuda").to(bf)
                for _ in range(2))
        s = torch.randn(d, generator=g, device="cuda").to(bf)
        out["add_rmsnorm"].append({
            "shape": [rows, d], "dtype": "bfloat16",
            **_times(torch, lambda: m["rms_ops"].add_rmsnorm_cuda(x, h, s),
                     lambda: (x + h, m["rmsnorm_ref"](x + h, s)),
                     lambda: F.rms_norm(torch.add(x, h), (d,), s, 1e-5)),
            **_bound(2 * (4 * rows * d + d), 5 * rows * d, FP32_FLOPS)})
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
    # MoE dispatch: deepseek decode (T=2), chunk (2 x 32), legacy bucket
    # at the model's capacity.  The plain version syncs with the host
    # (bincount), so its device time is from the profiler.  No library
    # call sorts and gathers; beside it, index_select does the gather
    # alone (x with one zero row appended, empty slots pointed at it,
    # the index map made before the timed call)
    cfg = m["get_config"](DEEPSEEK)
    for T in (2, 64, 128):
        E, k, d = 64, 6, 2048
        C = m["moe_capacity"](T, cfg)
        x, eidx = dispatch_inputs(torch, g, T, d, E, k, bf)
        _, dest_tk, counts = m["moe_dispatch_ref"](eidx, x, E, C)
        slot = torch.full((E * C + 1,), T, dtype=torch.long, device="cuda")
        slot[dest_tk.long()] = torch.arange(T * k, device="cuda") // k
        idx = slot[:E * C].contiguous()
        xz = torch.cat([x, torch.zeros(1, d, dtype=bf, device="cuda")])
        filled = int(torch.clamp(counts, max=C).sum())
        out["moe_dispatch"].append({
            "shape": [T, k, d, E, C], "dtype": "bfloat16", "filled": filled,
            "dropped": int(counts.sum()) - filled,
            **_times(torch,
                     lambda: m["dispatch_ops"].moe_dispatch_cuda(eidx, x, E,
                                                                 C),
                     lambda: m["moe_dispatch_ref"](eidx, x, E, C),
                     lambda: torch.index_select(xz, 0, idx),
                     plain_syncs=True),
            **_bound(8 * T * k + 2 * d * (filled + E * C) + 4 * T * k
                     + 4 * E, 0, BF16_FLOPS)})
    # SSD: zamba2's legacy prefill chunks (nc=1, Q = 64, 128) and its
    # 4096-token context (nc=16, Q=256); no single PyTorch call computes
    # it.  The products (C.B^T over causal pairs, M @ xdt, the state
    # product) run in 3xTF32 and count at that rate; the decay and
    # dec_end scaling at the fp32 rate
    for nc, Q in ((1, 64), (1, 128), (16, 256)):
        H, P, N = 112, 64, 64
        args = ssd_inputs(torch, g, nc, Q)
        pairs = Q * (Q + 1) // 2
        flops = nc * (pairs * 2 * N + H * pairs * (2 + 2 * P)
                      + H * Q * (N + 2 * N * P))
        tc_flops = nc * (pairs * 2 * N + H * pairs * 2 * P
                         + H * Q * 2 * N * P)
        nbytes = 4 * nc * (Q * H + 2 * Q * H * P + 2 * Q * N + H * N * P)
        out["ssd_intra"].append({
            "shape": [1, nc, Q, H, P, N], "dtype": "float32",
            **_times(torch, lambda: m["ssd_ops"].ssd_intra_cuda(*args),
                     lambda: m["ssd_intra_ref"](*args), None),
            **_bound(nbytes, flops, FP32_FLOPS, tc_flops)})
        del args
    return out


# ---------------------------------------------------------------------------
# the SIMT machine: one kernel launch per machine run
# ---------------------------------------------------------------------------

# benchmarks/fig9_rodinia.py:16-32 (the committed baseline's settings)
FIG9_CONFIGS = [(2, 2), (2, 8), (8, 2), (8, 8), (4, 16), (16, 4)]
FIG9_BENCHES = {  # name -> (kwargs, miss_latency)
    "vecadd": (dict(n=256), 16),
    "saxpy": (dict(n=256, repeats=8), 16),
    "sgemm": (dict(m=12, k=12, n=12), 16),
    "bfs": (dict(n_nodes=512, avg_deg=4), 200),
    "gaussian": (dict(n=16), 16),
    "nn": (dict(n=256), 16),
    "kmeans": (dict(n=128, k=8), 16),
}
FIG9_BASELINE = ROOT / "benchmarks" / "baselines" / "BENCH_fig9_rodinia.json"
FIG8_CONFIGS = [(1, 1), (2, 2), (2, 8), (4, 4), (2, 32), (8, 4), (8, 8),
                (8, 32), (16, 16), (32, 32)]           # benchmarks/fig8_dse.py
CLAIM_CONFIGS = [(2, 2), (2, 8), (8, 2), (8, 8)]      # test_paper_claims.py
NAMED_CELLS = ("vecadd/8w8t", "bfs/2w2t")


def _simt_config(m, w, t, miss_latency, **kw):
    return m["machine"].MachineConfig(warps=w, threads=t,
                                      max_cycles=12_000_000,
                                      miss_latency=miss_latency, **kw)


def _same_state(m, a, b) -> bool:
    torch, machine = m["torch"], m["machine"]
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in machine.State._fields if f != "stats")
            and machine.stats_dict(a) == machine.stats_dict(b))


def _recorded(m, fn):
    """fn() with every machine run recorded: (result, [(config,
    program, dmem image, final state)])."""
    machine, calls, real = m["machine"], [], m["machine"].run

    def recording(mc, program, dmem_image=None, **kw):
        out = real(mc, program, dmem_image=dmem_image, **kw)
        calls.append((mc, program, dmem_image, out))
        return out

    machine.run = recording
    try:
        return fn(), calls
    finally:
        machine.run = real


def simt_vs_plain(m) -> dict:
    """The kernel against the plain loop on the card, every State field
    and counter bit-equal: vecadd and nn at 8w8t and gaussian (both
    launches) at 4w16t at the Fig 9 sizes, a small bfs, and the edge-case
    programs (floats, aliasing and sub-word stores, IPDOM overflow)."""
    torch, machine, ec = m["torch"], m["machine"], m["edge_cases"]
    runs = [(name, w, t, FIG9_BENCHES[name][0], FIG9_BENCHES[name][1])
            for name, w, t in (("vecadd", 8, 8), ("nn", 8, 8),
                               ("gaussian", 4, 16))]
    runs.append(("bfs", 8, 8, dict(n_nodes=32, avg_deg=3), 200))
    launches = []
    for name, w, t, kw, ml in runs:
        (res, ok), calls = _recorded(m, lambda: m["rodinia"].BENCHMARKS[name](
            _simt_config(m, w, t, ml), device="cuda", **kw))
        _check(ok, f"simt {name} {w}w{t}t failed its oracle")
        launches += [(f"{name}/{w}w{t}t#{i}", *c) for i, c in
                     enumerate(calls)]
    edge_src, edge_img, _ = ec.alu_edges()
    for name, src, img, over in (
            ("alu_edges", edge_src, edge_img, dict(miss_latency=1)),
            ("alias_stores", ec.ALIAS_STORES, None, {}),
            ("ipdom_overflow", ec.IPDOM_OVERFLOW, None,
             dict(ipdom_depth=2, max_cycles=3000))):
        mc = machine.MachineConfig(warps=8, threads=8,
                                   **{"max_cycles": 100_000, **over})
        prog = m["assemble"](src)
        launches.append((name, mc, prog, img, machine.run(
            mc, prog, dmem_image=img, device="cuda")))
    out = {"launches": len(launches), "cycles": 0, "plain_s": 0.0,
           "plain_ms": {}}
    for name, mc, prog, img, got in launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = machine.run_plain(mc, prog, dmem_image=img, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check(_same_state(m, got, want),
               f"simt {name}: kernel state != plain state")
        cycles = int(want.cycle)
        out["cycles"] += cycles
        out["plain_s"] += dt
        out["plain_ms"][name] = [1e3 * dt, cycles]
    out["plain_ms_per_cycle"] = 1e3 * out["plain_s"] / out["cycles"]
    print(f"[simt] kernel == plain on the card, bit for bit: "
          f"{out['launches']} launches, {out['cycles']} cycles; plain "
          f"{out['plain_ms_per_cycle']:.3f} ms/cycle", flush=True)
    return out


def _profiled_cell(m, fn):
    """fn() under the profiler: (result, kernel ms, kernel launches, H2D
    ms, D2H ms), device times from ``torch.profiler``."""
    torch = m["torch"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    dev = {"kernel": [0.0, 0], "HtoD": [0.0, 0], "DtoH": [0.0, 0]}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("kernel" if "simt_kernel" in e.key else
               "HtoD" if "HtoD" in e.key else
               "DtoH" if "DtoH" in e.key else None)
        if key is not None:
            dev[key][0] += e.self_device_time_total / 1e3
            dev[key][1] += e.count
    return result, dev


def _simt_bound(mc, stats, launches: int, imem_words: int) -> dict:
    """The least time for a cell's work, as for every kernel: each
    launch's state read once and written once (dmem, smem, GPRs, ...)
    and its program read once, over HBM's rate, against one operation
    per issued lane at the fp32 rate.  A serial interpreter is nowhere
    near either; its yardstick is time per simulated cycle."""
    W, T, D = mc.warps, mc.threads, mc.ipdom_depth
    words = (mc.dmem_words + mc.smem_words + W * T * 32 + 3 * mc.sets
             + W * (8 + 3 * D) + mc.barriers * (1 + W) + W * D * T / 4)
    return _bound(launches * 2 * 4 * words + 4 * imem_words,
                  stats["issued_lanes"], FP32_FLOPS)


def simt_phase(m) -> dict:
    """The SIMT machine on the card: the kernel against the plain loop;
    the Fig 9 grid through the Rodinia benches (the main path: the
    kernel's launch count zeroed before it, read after), every cell's 16
    counters and cycles equal to the committed baseline and its numpy
    oracle passed; the paper's four claims on the port's own numbers;
    the Fig 8 rows and Fig 10's best configuration per bench."""
    torch, power, machine = m["torch"], m["power"], m["machine"]
    vs_plain = simt_vs_plain(m)
    baseline = json.loads(FIG9_BASELINE.read_text())
    keys = machine.STAT_KEYS + ("cycles",)
    stats, cells = {}, {}
    m["simt_ops"].launches = 0
    t0 = time.perf_counter()
    for name, (kw, ml) in FIG9_BENCHES.items():
        for w, t in FIG9_CONFIGS:
            cell = f"{name}/{w}w{t}t"
            ((res, ok), calls), dev = _profiled_cell(m, lambda: _recorded(
                m, lambda: m["rodinia"].BENCHMARKS[name](
                    _simt_config(m, w, t, ml), device="cuda", **kw)))
            _check(ok, f"simt {cell} failed its numpy oracle")
            want = {k: baseline[cell]["stats"][k] for k in keys}
            got = {k: res.stats[k] for k in keys}
            _check(got == want, f"simt {cell}: counters {got} != the "
                   f"committed baseline's {want}")
            stats[(name, w, t)] = res.stats
            cells[cell] = {
                "cycles": res.stats["cycles"], "launches": dev["kernel"][1],
                "kernel_ms": dev["kernel"][0],
                "ns_per_cycle": 1e6 * dev["kernel"][0] / res.stats["cycles"],
                "h2d_ms": dev["HtoD"][0], "d2h_ms": dev["DtoH"][0],
                "bound": _simt_bound(calls[0][0], res.stats, len(calls),
                                     sum(len(c[1]) for c in calls))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grid_launches = m["simt_ops"].launches
    n_launch = sum(c["launches"] for c in cells.values())
    want = len(cells) + len(FIG9_CONFIGS)       # gaussian launches twice
    _check(grid_launches == n_launch == want,
           f"simt grid: {grid_launches} wrapper launches, {n_launch} "
           f"profiled kernels, want {want}")
    total_cycles = sum(c["cycles"] for c in cells.values())
    kernel_ms = sum(c["kernel_ms"] for c in cells.values())
    print(f"[simt] Fig 9: {len(cells)}/42 cells match the baseline, "
          f"{total_cycles} cycles in {kernel_ms:.2f} kernel ms "
          f"({1e6 * kernel_ms / total_cycles:.1f} ns/cycle), "
          f"{grid_launches} launches, {wall:.2f} s wall", flush=True)

    # the paper's claims (tests/test_paper_claims.py's grid: its bfs runs
    # are the Fig 9 bfs cells, saxpy re-walks its data 16 times)
    grid = {}
    for w, t in CLAIM_CONFIGS:
        res, ok = m["rodinia"].saxpy(_simt_config(m, w, t, 16), n=256,
                                     repeats=16, device="cuda")
        _check(ok, f"claims: saxpy {w}w{t}t failed its oracle")
        grid[("saxpy", w, t)] = res.stats["cycles"]
        grid[("bfs", w, t)] = stats[("bfs", w, t)]["cycles"]
    gain_threads = grid[("saxpy", 2, 2)] / grid[("saxpy", 2, 8)]
    gain_warps = grid[("saxpy", 2, 2)] / grid[("saxpy", 8, 2)]
    bfs_warp_gain = grid[("bfs", 2, 2)] / grid[("bfs", 8, 2)]
    _check(gain_threads > 2.0 and gain_threads > 2 * gain_warps,
           f"claim (i): thread gain {gain_threads}, warp gain {gain_warps}")
    _check(bfs_warp_gain > gain_warps,
           f"claim (ii): bfs warp gain {bfs_warp_gain} <= saxpy's "
           f"{gain_warps}")

    def best(bench, configs, cycles):
        effs = {(w, t): power.power_efficiency(cycles[(bench, w, t)], w,
                                               t).perf_per_watt
                for w, t in configs}
        return max(effs, key=effs.get)

    sax_best = best("saxpy", CLAIM_CONFIGS, grid)
    bfs_best = best("bfs", CLAIM_CONFIGS, grid)
    _check(sax_best == (2, 8) and bfs_best[0] >= sax_best[0],
           f"claim (iii): best perf/W saxpy {sax_best}, bfs {bfs_best}")
    d2, d32 = (power.area(16, 2) - power.area(8, 2),
               power.area(16, 32) - power.area(8, 32))
    _check(power.area_normalized(2, 32) > power.area_normalized(32, 2) * 0.99
           and d32 > 4 * d2
           and power.power_normalized(8, 8) > power.power_normalized(4, 8)
           > power.power_normalized(2, 2)
           and abs(power.power_mw(8, 4) - power.PAPER_ANCHOR_MW) < 1e-6,
           "claim (iv): area/power scaling")
    fig8 = {f"{w}w{t}t": [power.area_normalized(w, t),
                          power.power_normalized(w, t),
                          power.cell_count_normalized(w, t),
                          power.power_mw(w, t)] for w, t in FIG8_CONFIGS}
    fig10 = {name: "{}w{}t".format(*best(name, FIG9_CONFIGS, {
        k: v["cycles"] for k, v in stats.items()})) for name in FIG9_BENCHES}
    print("[simt] Fig 8 (area, power, cells normalised to 1w1t; mW): "
          + json.dumps(fig8), flush=True)
    print(f"[simt] Fig 10 most power-efficient config: {fig10}", flush=True)
    named = {c: cells[c] for c in NAMED_CELLS}
    return {
        "cells_matched": len(cells), "cells": 42,
        "total_cycles": total_cycles, "launches": grid_launches,
        "kernel_ms": kernel_ms,
        "kernel_ms_per_launch": kernel_ms / grid_launches,
        "ns_per_cycle": 1e6 * kernel_ms / total_cycles,
        "h2d_ms_per_launch": sum(c["h2d_ms"] for c in cells.values())
        / grid_launches,
        "d2h_ms_per_launch": sum(c["d2h_ms"] for c in cells.values())
        / grid_launches,
        "grid_wall_s": wall, "named_cells": named,
        "plain_ms_per_cycle": vs_plain["plain_ms_per_cycle"],
        "plain": vs_plain,
        "claims": {"i_thread_gain": gain_threads, "i_warp_gain": gain_warps,
                   "ii_bfs_warp_gain": bfs_warp_gain,
                   "iii_best_saxpy": "{}w{}t".format(*sax_best),
                   "iii_best_bfs": "{}w{}t".format(*bfs_best),
                   "iv_dwarp_t32_over_t2": d32 / d2},
        "fig10_best": fig10,
        "cell_ms": {c: [v["kernel_ms"], v["ns_per_cycle"]]
                    for c, v in cells.items()}}


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

    simt = simt_phase(m)
    print(json.dumps({"simt": simt}), flush=True)
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
        "add_rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm/kernel.py:31", 2),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:101",
                            1),
        "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu",
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
            "library_ms": t["library_ms"], "call_ms": t["call_ms"],
            "plain_call_ms": t["plain_call_ms"]})
        if name == "flash_attention":
            routes = m["fa_ops"].ROUTES
            kernels[-1]["routes"] = {str(dt).replace("torch.", ""): r
                                     for dt, r in routes.items()}
            kernels[-1]["launches_by_route"] = {
                r: sum(serve[p]["flash_launches_by_route"][r] for p in paths)
                for r in routes.values()}
        _check(kernels[-1]["launches"] > 0, f"{name}: no launch on a path")
    # the SIMT machine: its main path is the Fig 9 grid; timed at
    # vecadd/8w8t (one launch), its plain loop on the same launch (host
    # clock: the loop reads the card every cycle)
    cell = simt["named_cells"]["vecadd/8w8t"]
    kernels.append({
        "name": "simt_machine", "route": "cuda",
        "source": "src/repro_torch/csrc/simt_machine.cu",
        "replaces": "src/repro/core/simt/machine.py:646",
        "launches": simt["launches"], "max_abs_err": 0.0,
        "shape": "vecadd/8w8t", "ms": cell["kernel_ms"],
        "plain_ms": simt["plain"]["plain_ms"]["vecadd/8w8t#0"][0],
        "bound_ms": cell["bound"]["bound_ms"],
        "bound_by": cell["bound"]["bound_by"], "library_ms": None,
        "ns_per_cycle": cell["ns_per_cycle"]})
    print(f"[done] {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
