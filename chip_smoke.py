#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and a checkout of the repository around this file;
without either it exits non-zero and prints no result.  Imports nothing
of JAX and nothing of the ``repro`` package.  In order:

1. builds the eight CUDA sources (RMSNorm with its fused residual-add
   form and its backward, the flash-attention forward, its FA-2
   backward, the MoE dispatch, SSD intra-chunk and its backward, the
   SIMT machine's cycle loop, the int8 decode attention) from
   ``src/repro_torch/csrc/``, one ``nvcc`` per source, in parallel, and
   prints each library's registers, stack and spill bytes by kernel and
   template arguments;
2. drives the Vortex SIMT machine: the kernel (one launch per machine
   run) against the plain PyTorch loop on the card, every State field
   and counter bit-equal (vecadd and nn at 8w8t, gaussian at 4w16t at
   the Fig 9 sizes, a small bfs, and the edge-case programs of
   ``runtime/kernels_src/edge_cases.py``); then the Fig 9 grid (42
   cells, ``benchmarks/fig9_rodinia.py``'s settings) through the Rodinia
   benches, each cell passing its numpy oracle and matching the
   committed ``benchmarks/baselines/BENCH_fig9_rodinia.json`` in its 16
   counters and cycles, each cell's kernel time under the profiler (a
   cell whose profile misses a kernel's record is run and profiled
   again, at most twice) and
   its SM clocks per simulated cycle (``nvidia-smi``'s SM clock sampled
   through the grid); the paper's four claims
   (``tests/test_paper_claims.py``) on the port's own numbers, the Fig 8
   rows and Fig 10's best configuration per bench; it prints a
   ``{"simt": ...}`` line;
3. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes (the MoE dispatch bit-exact in its buffer,
   slots and counts, also at a 4096-token prefill, with and without
   capacity drops; the fused norm's sum bit-exact; flash in bf16 on its
   wgmma/TMA route and in fp32 on its FMA route, also at zamba2's
   head_dim 112, and in bf16 at long prefills of 4096 tokens and a
   ragged S = 200; SSD at chunks of 1, 64, 65, 128 and 256 tokens, at
   16 chunks of 256 and with steep decay, and its worst error /
   tolerance against an fp64 plain version over three seeds; flash
   non-causal with Sk != S at whisper's encoder and cross-attention
   shapes, also from buffers whose rows past S hold NaN, causal at D 64
   and 128 with GQA at qwen's, minitron's and internvl's shapes, and
   RMSNorm at d 384 to 8192), and reduced fp32 phi3, deepseek-moe-16b,
   zamba2-7b, xlstm-125m, whisper-tiny and internvl2-76b prefills on
   the card (kernels) against the same models on the CPU (plain
   versions);
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
   paged layout; then, each on an otherwise empty card,
   ``qwen2.5-32b`` (~65.5 GB of weights) and ``minitron-4b`` chunked
   and legacy, as (a) and (b), and ``olmoe-1b-7b`` chunked; and the
   families the serving engine does not run (in neither package)
   through ``api.forward``, a 64-token prompt then 8 greedy decode
   steps: ``xlstm-125m``, ``whisper-tiny`` with 1500 stub frames and
   the ``internvl2-76b`` backbone with 256 stub patches, its depth cut
   to 24 of 80 layers (full width; the whole model is 139 GB in bf16),
   each also with its prefill + decode against a longer prefill
   (cosine >= 0.99); and zamba2-7b again, on an empty card, with the
   long-context cell's windowed shared attention (``long_context``,
   window 4096): a prefill of exactly 4096 tokens fills each shared
   attention cache, a ring of 4096 slots, and 8 greedy decode steps
   wrap it; the same again in fp32 from the same seed, where each step
   must be within cosine 0.9999 of a windowed prefill of the same
   tokens (the bf16 cosines are printed: at 4096 tokens bf16 rounding
   alone moves them below 0.99).  Every path's tokens are printed as a
   digest
   (``token_digest``), so that runs can be compared path by path.
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
   (``call_ms``, host included); flash also at the long prefills and at
   the new paths' shapes (whisper's encoder and cross-attention, D 128
   with GQA against SDPA's ``enable_gqa``), RMSNorm also at d 384,
   5120 and 8192; SSD also at 16 chunks of 256.

7. trains ``h2o-danube-1.8b`` (the train phase, after the serve
   models are freed): the two backward kernels (FA-2 flash, RMSNorm in
   both forms) against their plain versions at danube's full-width
   shapes (D 80, 32 / 8 heads, S 8192 under the 4096 window) and short
   ragged ones, in bf16 and fp32, each run twice for identical bits;
   reduced danube (window 16, S 64) one fp32 step on the card against
   the CPU (loss, grad norm, every grad leaf, the updated params), 30
   bf16 steps on one batch (loss below 0.7x its first value), and the
   chaos resume under ``faults.training_plan(2)`` against a fault-free
   run, bit for bit; then full-width danube through
   ``launch.train.main`` (seq 8192, batch 2, microbatch 1, remat full,
   3 steps: finite loss and grad norm, step ms, tokens/s, peak GB),
   one step under the profiler, and each backward kernel timed against
   its plain version and a library yardstick (flash also on the same
   work as SDPA's causal backward, at S 4096 where its window cannot
   bind); the build's registers, stack and spill bytes of every FA-2
   backward instance are carried in the kernels line;
8. trains the MoE and hybrid families: the MoE dispatch's backward
   (a gather-sum per token) bit-exact with its plain version at
   olmoe-1b-7b's and deepseek-moe-16b's widths (T 1 / 64 / 4096, C
   tight and ample, bf16 and fp32), SSD's intra-chunk backward within
   1e-4 (max |Δ| / max |want|) of the plain backward in fp64 at
   zamba2-7b's train shape [1,16,256,112,64,64] and a prefill chunk,
   mild and steep decay, both run twice for identical bits, and flash
   forward and backward at D 128 and D 112; reduced fp32 olmoe,
   deepseek and zamba2 one step on the card against the CPU (remat
   full; a recomputed MoE layer must route as its forward did); then
   full width with the depth cut, bf16, seq 4096, batch 2 in
   microbatches of 1, remat full, lr 3e-5, 3 steps through
   ``training.loop.make_train_step`` and ``data.pipeline.Loader``:
   ``train_moe`` (olmoe-1b-7b, 7 of 16 layers) and ``train_hybrid``
   (zamba2-7b, 33 of 81 Mamba blocks: 5 groups of 6 and the shared
   block, then the 3-block tail), each step's loss, grad norm, ms,
   tokens/s and peak GB printed beside the depth cut, every kernel of
   the path launched; and the new backward kernels timed against their
   plain versions and, for the dispatch, ``torch.index_add``; SSD's
   backward also by launch under the profiler, its bound counting its
   products at 3xTF32 (the fp32-FMA figure beside it), and its ptxas
   usage carried in the kernels line;
9. trains the xlstm, audio and vlm families: flash forward and FA-2
   backward first at their new forms (whisper-tiny's encoder, non-causal
   over 1500 frames; its cross-attention, 4096 queries on 1500 keys;
   its causal decoder at D 64; the internvl2-76b backbone's D 128 with
   8 query heads to a kv head; a ragged S 130 on Sk 77), bf16 and fp32,
   backward runs twice for identical bits, the forward with a 4096
   window at S 4104 and D 112 (long-context zamba2's shared attention),
   and the RMSNorm forward and backward, both forms, at the families'
   rows and widths (d 768, 384 and 8192); reduced fp32 xlstm-125m (an
   mLSTM and an sLSTM block), whisper-tiny and internvl2-76b one step
   on the card against the CPU, as in 8.; then, as ``train_moe``,
   xlstm-125m (12 of 12 layers on 2048 tokens, FAMILY_SEQ_OF; its
   profiled step gives the sLSTM blocks' share of the host's time), whisper-tiny (4 + 4 layers, 1500
   stub frames) and the internvl2-76b backbone cut to 1 of 80 layers,
   each step's loss, grad norm, ms, tokens/s and peak GB printed; and
   the new flash forms timed against SDPA (``enable_gqa`` for
   internvl; the window as a mask).  Each profiled step names the
   RMSNorm backward instances its widths picked.

10. drives the int8 KV-cache decode path (``kv_q8_phase``, after the
   serve phase): the ``decode_attention_q8`` kernel, one launch a call
   (a thread-block cluster a (b, kv), the scores in shared memory; the
   scratch form for caches whose scores do not fit), against its plain
   version (fp64 products on the card) at phi3's, qwen2.5-32b's and
   internvl2-76b's decode shapes, danube's 4096-slot ring after it
   wraps, a window of 64 that is not a ring, per-slot lens (1, 77, 256),
   minitron-4b's 3 query heads a kv head and [1,131072,2,8,128] (the
   scratch form), bf16 and fp32 q: the int32 scores equal, pq at most
   one step apart at few entries, the output within tolerance of the
   plain sums over the kernel's pq, the same bits twice; its timing at
   [16,32768,8,G 5,128] (qwen2.5-32b's decode_32k layer over 16 slots)
   against its bytes bound, with SDPA over a bf16 cache of that shape
   beside it as a different function, its plan (form, cluster size,
   shared bytes a block, clusters in flight), its launches a call (the
   kernel nodes of a CUDA graph that captured one call) and every
   instance's ptxas registers and spill bytes (none may spill),
   and its device ms a call at each path's shape; its split form (a
   context-parallel decode's four stage launches a block around the
   exchanges of the row max, sum of exponentials, max |pv| and int32
   P·V sums, ``kv_q8_split``) at that shape in 1, 4 and 16 position
   blocks with per-slot lens that mask whole blocks, the exchanges done
   by torch on the card: each stage against its plain stage, the output
   against the plain version and the one launch (pq steps that differ
   counted), the stages' launches (their main path), device ms, bounds
   and ptxas spills; phi3-mini-3.8b,
   qwen2.5-32b, olmoe-1b-7b and the internvl2-76b backbone (24 of 80
   layers) at full width, each fed a 64-token prompt one decode step at
   a time from empty int8 caches and then 8 greedy tokens, every launch
   count zeroed just before and read just after (the kernel once a
   layer a step), and the same input tokens again on a bf16 cache
   (agreeing greedy tokens and logit cosines printed, not gated: the
   weights are random); and reduced fp32 phi3, danube (its 16-slot ring
   wraps) and qwen 24 steps on the card against the CPU.

11. drives the distributed layer (``mesh_phase``, after the train
   phase) in a world of one rank over NCCL: full-width
   h2o-danube-1.8b through ``launch.train.main`` for 2 steps without
   and with ``--mesh`` (losses and grad norms bit-equal; the
   data-parallel step's NCCL all-reduces counted); one full-width
   olmoe-1b-7b MoE layer, x [2,4096,2048] bf16 with no capacity drops,
   through the expert-parallel a2a path at ep 1 against the sort path
   (y, aux and the grad of x; the dispatch kernel and its backward
   launched on ``mesh_a2a``; each form's forward device ms); and
   ``compressed_psum``, ``ring_all_gather``, ``barrier`` and
   ``grid_spawn`` on CUDA tensors.

12. drives the dry-run and roofline layer (``dryrun_phase``, last):
   ``python -m repro_torch.launch.dryrun --all --mesh both`` over every
   (arch x shape x mesh) cell on meta tensors, in separate processes,
   where no cell may fail and every cell is partitioned (on fake worlds
   of 256 and 512 ranks, walked per device, the MoE cells' a2a dispatch
   included, the xlstm train and prefill cells through the walk's
   quadratic fit); then the cells of ``DRYRUN_CHECKS`` that
   fit one card, built at full width through ``launch.cells`` in a
   world of one rank over NCCL (phi3-mini-3.8b prefill [1, 4096] and
   decode at batch 16 over 4096 slots, on bf16 and on int8 caches,
   h2o-danube-1.8b train [2, 4096] in microbatches of 1 with remat
   full, olmoe-1b-7b decode at batch 16 over 4096 slots and train
   [2, 4096] at 7 of 16 layers, deepseek-moe-16b prefill [1, 4096],
   zamba2-7b prefill, decode and train at 33 of 81 blocks, whisper-tiny
   train, prefill and decode, xlstm-125m train [2, 320], prefill
   [1, 1024] and decode at batch 16 over 4096 tokens); all partitioned,
   DTensors on the 1 x 1 mesh with the flash, RMSNorm, int8 decode,
   SSD and MoE dispatch kernels on local shards, each after its whole
   run,
   whose outputs its own must equal bit for bit, else within a
   tolerance with the first differing output named): each step timed
   between CUDA events, walked under
   ``roofline.op_cost`` on CUDA and on meta (the FLOPs, bytes and
   declared kernel costs must be equal), the placed argument bytes
   against the materialized arguments', the state bytes against the
   peak, the roofline bound on ``H100`` against the measured step (the
   bound may not exceed it) and ``FlopCounterMode``'s product FLOPs
   against ``op_cost``'s; each check cell is a path of the kernels
   line.

It prints a ``{"simt": ...}`` line, a ``{"serve": ...}`` line, a
``{"kv_q8": ...}`` line, a ``{"timings": ...}`` line, a ``{"train":
...}`` line, a ``{"mesh": ...}`` line, a ``{"dryrun": ...}`` line, one
``{"kernels": [...]}`` line,
the card's name and power limit, and ends with ``{"ok": true,
"device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math
import re
import shutil
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
QWEN, MINITRON, OLMOE = "qwen2.5-32b", "minitron-4b", "olmoe-1b-7b"
XLSTM, WHISPER, INTERNVL = "xlstm-125m", "whisper-tiny", "internvl2-76b"
INTERNVL_LAYERS = 24    # of 80: the full backbone is 139 GB in bf16
KERNELS = ("rmsnorm", "add_rmsnorm", "flash_attention", "moe_dispatch",
           "ssd_intra")
BWD_KERNELS = ("flash_attention_bwd", "rmsnorm_bwd", "add_rmsnorm_bwd",
               "moe_dispatch_bwd", "ssd_intra_bwd")
OUR_KERNELS = {  # kernel: its CUDA functions' names, as the profiler shows
    "rmsnorm": r"(?<!add_)rmsnorm_kernel", "add_rmsnorm": r"add_rmsnorm_kernel",
    "flash_attention": r"flash_fwd_", "moe_dispatch": r"moe_dispatch_kernel",
    "ssd_intra": r"ssd_intra_kernel", "flash_attention_bwd": r"flash_bwd_",
    "rmsnorm_bwd (both forms)": r"rmsnorm_(bwd|dscale)_kernel",
    "moe_dispatch_bwd": r"moe_dispatch_bwd_kernel",
    "ssd_intra_bwd": r"ssd_bwd_"}
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
    from repro_torch.kernels.decode_q8 import ops as q8_ops
    from repro_torch.kernels.decode_q8 import ref as q8_ref
    from repro_torch.kernels.decode_q8.ref import (combine_pv,
                                                   decode_attention_q8_ref)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         flash_bwd_ref,
                                                         flash_fwd_ref)
    from repro_torch.kernels.moe_dispatch import ops as dispatch_ops
    from repro_torch.kernels.moe_dispatch.ref import (moe_dispatch_bwd_ref,
                                                      moe_dispatch_ref)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                                 rmsnorm_bwd_ref, rmsnorm_ref)
    from repro_torch.core import combinators, spawn
    from repro_torch.distributed import collectives, compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells as cells_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_cli
    from repro_torch.roofline import analysis as roof_analysis
    from repro_torch.roofline import op_cost
    from repro_torch.roofline.hw import H100
    from repro_torch.kernels.simt_machine import ops as simt_ops
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_scan.ref import (ssd_intra_bwd_ref,
                                                  ssd_intra_ref)
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import moe_a2a
    from repro_torch.models import xlstm, xlstm_lm
    from repro_torch.models.kv_quant import quantize_kv, valid_positions
    from repro_torch.models.moe import moe_capacity, moe_forward
    from repro_torch.obs import demo  # noqa: F401  (its imports, checked)
    from repro_torch.runtime.asm import assemble
    from repro_torch.runtime.kernels_src import edge_cases, rodinia
    from repro_torch.serving import kv_pool
    from repro_torch.serving.engine import Engine
    from repro_torch.training import loop as train_loop
    from repro_torch.training.resilient import train_with_recovery
    return dict(np=np, torch=torch, F=F, bridge=bridge, obs=obs,
                CheckpointManager=CheckpointManager, ShapeConfig=ShapeConfig,
                TrainConfig=TrainConfig, Loader=Loader,
                SyntheticLM=SyntheticLM, flash_bwd_ref=flash_bwd_ref,
                flash_fwd_ref=flash_fwd_ref,
                add_rmsnorm_bwd_ref=add_rmsnorm_bwd_ref,
                rmsnorm_bwd_ref=rmsnorm_bwd_ref, train_cli=train_cli,
                combinators=combinators, spawn=spawn,
                collectives=collectives, compression=compression, shd=shd,
                mesh_mod=mesh_mod, moe_a2a=moe_a2a, cells_mod=cells_mod,
                roof_analysis=roof_analysis, op_cost=op_cost, H100=H100,
                train_loop=train_loop,
                train_with_recovery=train_with_recovery,
                faults=faults, kv_pool=kv_pool,
                get_config=get_config, reduced_config=reduced_config,
                build=build, fa_ops=fa_ops, attention_ref=attention_ref,
                q8_ops=q8_ops, q8_ref=q8_ref, combine_pv=combine_pv,
                decode_attention_q8_ref=decode_attention_q8_ref,
                quantize_kv=quantize_kv, valid_positions=valid_positions,
                dispatch_ops=dispatch_ops, moe_dispatch_ref=moe_dispatch_ref,
                moe_dispatch_bwd_ref=moe_dispatch_bwd_ref, moe_mod=moe_mod,
                rms_ops=rms_ops, rmsnorm_ref=rmsnorm_ref, ssd_ops=ssd_ops,
                ssd_intra_ref=ssd_intra_ref,
                ssd_intra_bwd_ref=ssd_intra_bwd_ref, api=api, Engine=Engine,
                moe_capacity=moe_capacity, moe_forward=moe_forward,
                machine=machine, power=power, simt_ops=simt_ops,
                xlstm=xlstm, xlstm_lm=xlstm_lm,
                assemble=assemble, edge_cases=edge_cases, rodinia=rodinia)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _zero_counts(m) -> None:
    for mod in ("rms_ops", "fa_ops", "dispatch_ops", "ssd_ops", "q8_ops"):
        m[mod].launches = 0
    for mod in ("rms_ops", "fa_ops", "dispatch_ops", "ssd_ops"):
        m[mod].bwd_launches = 0
    for by in (m["rms_ops"].launches_by_form, m["fa_ops"].launches_by_route,
               m["rms_ops"].bwd_launches_by_form, m["rms_ops"].row_launches,
               m["q8_ops"].stage_launches):
        for key in by:
            by[key] = 0


def _counts(m) -> dict:
    """Launches of each kernel of KERNELS and BWD_KERNELS, of
    decode_attention_q8 (its one launch) and its split form's stages,
    and of the split-row norm's NORM_SPLIT_KERNELS (the RMSNorm wrapper
    counts its forms apart)."""
    bwd = m["rms_ops"].bwd_launches_by_form
    stages = m["q8_ops"].stage_launches
    return {**m["rms_ops"].launches_by_form, **m["rms_ops"].row_launches,
            **stages,
            "flash_attention": m["fa_ops"].launches,
            "moe_dispatch": m["dispatch_ops"].launches,
            "ssd_intra": m["ssd_ops"].launches,
            "decode_attention_q8": (m["q8_ops"].launches
                                    - sum(stages.values())),
            "flash_attention_bwd": m["fa_ops"].bwd_launches,
            "rmsnorm_bwd": bwd["rmsnorm"],
            "add_rmsnorm_bwd": bwd["add_rmsnorm"],
            "moe_dispatch_bwd": m["dispatch_ops"].bwd_launches,
            "ssd_intra_bwd": m["ssd_ops"].bwd_launches}


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

def dispatch_checks(m, g, arch: str, Ts) -> None:
    """The MoE dispatch against its plain version, bit-exact, at `arch`'s
    widths, for each token count T in `Ts`, bf16 and fp32: C tight (one
    average expert's load, so popular experts drop pairs), the model's
    capacity, and ample (C = T: no expert can overflow)."""
    torch = m["torch"]
    cfg = m["get_config"](arch)
    E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    drops = {}
    for dt in (torch.bfloat16, torch.float32):
        for T in Ts:
            x, eidx = dispatch_inputs(torch, g, T, d, E, k, dt)
            for kind, C in (("tight", max(1, T * k // E)),
                            ("model", m["moe_capacity"](T, cfg)),
                            ("ample", T)):
                got = m["dispatch_ops"].moe_dispatch_cuda(eidx, x, E, C)
                torch.cuda.synchronize()
                want = m["moe_dispatch_ref"](eidx, x, E, C)
                for name, a, b in zip(("buf", "dest_tk", "counts"), got,
                                      want):
                    _check(a.dtype == b.dtype and torch.equal(a, b),
                           f"moe_dispatch {arch} {dt} T={T} C={C}: {name} "
                           f"not bit-exact")
                drops[f"{T}/{kind}"] = int((got[1] == E * C).sum())
                del got, want
            del x, eidx
    _check(all(drops[f"{T}/ample"] == 0 for T in Ts)
           and all(drops[f"{T}/tight"] > 0 for T in Ts if T >= 64),
           f"moe_dispatch {arch}: dropped pairs {drops}")
    print(f"[kernels] moe_dispatch {arch} (E {E}, top-{k}, d {d}) dropped "
          f"pairs (last dtype): {drops}", flush=True)


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
    # (N = 24576 pairs); then at olmoe-1b-7b's (E = 64, top-8, d = 2048)
    # on its serve path's token counts, from a generator of its own
    dispatch_checks(m, g, DEEPSEEK, (1, 2, 64, 128, 4096))
    dispatch_checks(m, torch.Generator(device="cuda").manual_seed(SEED + 6),
                    OLMOE, (1, 2, 32, 64, 128, 4096))
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
    errs["new_shapes"], errs["noncausal_normalized"] = new_shape_checks(m)
    for key, e in errs["new_shapes"].items():
        name = key.split()[0]
        errs[name] = max(errs[name], e)
    return errs


# (S, Sk, H, KV, D, causal) of the flash calls on the paths that
# whisper-tiny, qwen2.5-32b, minitron-4b and internvl2-76b add
FLASH_NEW = {
    "whisper encoder [1,1500,6,64] non-causal":
        (1500, 1500, 6, 6, 64, False),
    "whisper cross [1,64,6,64]x[1,1500,6,64]":
        (64, 1500, 6, 6, 64, False),
    "whisper cross [1,65,6,64]x[1,1500,6,64]":
        (65, 1500, 6, 6, 64, False),
    "whisper decoder [1,64,6,64] causal": (64, 64, 6, 6, 64, True),
    "qwen [1,128,40,128] kv 8 causal": (128, 128, 40, 8, 128, True),
    "minitron [1,128,24,128] kv 8 causal": (128, 128, 24, 8, 128, True),
    "internvl [1,320,64,128] kv 8 causal": (320, 320, 64, 8, 128, True)}
# (rows, d) of the norms those paths add: whisper (d 384; 1500 encoder
# rows), xlstm (d 768, the mLSTM's inner 1536), minitron 3072, qwen
# 5120, internvl 8192
NORM_NEW = ((2, 384), (64, 384), (1500, 384), (64, 768), (64, 1536),
            (128, 3072), (2, 5120), (128, 5120), (2, 8192), (320, 8192))


# non-causal flash spreads each row's softmax over all Sk keys, so |o|
# is small (RMS about 0.04 at Sk 1500) and an absolute bound is loose:
# these rows are also held to max |got - want| / max |want| (bf16: a
# few roundings of the output, 2^-9 of an element each; fp32: the order
# of the sums), and the plain version with the last SPREAD_DROP keys
# left out (a kernel that loses a ragged last kv tile: 28 keys is the
# least last tile of any route at Sk 1500) must read above the bound
SPREAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
SPREAD_DROP = 28


def _spread_check(m, q, k, v, got, want, name, what) -> dict:
    """{"normalized_err", "control"} of one non-causal call (SPREAD_TOL)."""
    torch = m["torch"]
    tol = SPREAD_TOL[name]
    _, rel = _rel_err(torch, got, want, tol, f"flash {what} {name}")
    Sk = k.shape[1] - SPREAD_DROP
    cut = m["attention_ref"](q, k[:, :Sk], v[:, :Sk], causal=False)
    ctrl = float((cut.float() - want.float()).abs().max()
                 / want.float().abs().max())
    _check(ctrl > tol, f"flash {what} {name}: the plain version without "
           f"its last {SPREAD_DROP} keys reads {ctrl}, not above {tol}")
    return {"normalized_err": rel, "control": ctrl}


def new_shape_checks(m) -> tuple:
    """Flash and RMSNorm against their plain versions at the shapes the
    new paths give them, bf16 and fp32: flash non-causal with Sk != S
    (whisper's encoder and cross-attention), causal at D 64 and 128
    with GQA; the encoder shape again with q, k and v cut from buffers
    whose rows past S hold NaN, so a load past S or a key past Sk that
    is not masked shows.  Returns ({"<kernel> <shape> <dtype>": max abs
    error}, {"<shape> <dtype>": _spread_check of each non-causal
    call})."""
    torch, fa = m["torch"], m["fa_ops"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out, spread = {}, {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        name = str(dt).replace("torch.", "")
        for what, (S, Sk, H, KV, D, causal) in FLASH_NEW.items():
            q = torch.randn(1, S, H, D, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(1, Sk, KV, D, generator=g, device="cuda")
                    .to(dt) for _ in range(2))
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = m["attention_ref"](q, k, v, causal=causal)
            out[f"flash_attention {what} {name}"] = _max_err(
                torch, got, want, tol, f"flash {what} {name}")
            if not causal:
                spread[f"{what} {name}"] = _spread_check(
                    m, q, k, v, got, want, name, what)
            del q, k, v, got, want
        # NaN past row 1500 of each buffer: the kernel reads [:1500]
        bufs = [torch.full((1, 1600, 6, 64), float("nan"), device="cuda",
                           dtype=dt) for _ in range(3)]
        for b in bufs:
            b[:, :1500] = torch.randn(1, 1500, 6, 64, generator=g,
                                      device="cuda").to(dt)
        q, k, v = (b[:, :1500] for b in bufs)
        got = fa.flash_attention_cuda(q, k, v, causal=False)
        torch.cuda.synchronize()
        want = m["attention_ref"](q, k, v, causal=False)
        what = "encoder, NaN past S and Sk"
        out[f"flash_attention {what} {name}"] = _max_err(
            torch, got, want, tol, f"flash {what} {name}")
        spread[f"{what} {name}"] = _spread_check(m, q, k, v, got, want,
                                                 name, what)
        del bufs, q, k, v, got, want
        norm_tol = 2e-2 if dt == torch.bfloat16 else 1e-5
        for rows, d in NORM_NEW:
            x, h = (torch.randn(rows, d, generator=g, device="cuda")
                    .to(dt) for _ in range(2))
            w = torch.randn(d, generator=g, device="cuda").to(dt)
            got = m["rms_ops"].rmsnorm_cuda(x, w)
            s2, y = m["rms_ops"].add_rmsnorm_cuda(x, h, w)
            torch.cuda.synchronize()
            what = f"[{rows},{d}] {name}"
            out[f"rmsnorm {what}"] = _max_err(
                torch, got, m["rmsnorm_ref"](x, w), norm_tol,
                f"rmsnorm {what}")
            _check(torch.equal(s2, x + h),
                   f"add_rmsnorm {what}: sum not bit-exact")
            out[f"add_rmsnorm {what}"] = _max_err(
                torch, y, m["rmsnorm_ref"](x + h, w), norm_tol,
                f"add_rmsnorm {what}")
    print(f"[kernels] flash non-causal, max |err| / max |want| (bound "
          f"{SPREAD_TOL}) and the same without the last {SPREAD_DROP} "
          f"keys: {json.dumps(spread)}", flush=True)
    return out, spread


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
    # the xlstm, audio and vlm families, with their stub frontends'
    # embeddings: launches per prefill (xlstm: each block's norm and
    # each cell's inner norm, no attention; whisper: E encoder and L
    # decoder layers, flash for the encoder, the decoder's self- and
    # cross-attention; the vlm backbone as a dense decoder)
    for arch, layers in ((XLSTM, 8), (WHISPER, 2), (INTERNVL, 2)):
        cfg = m["reduced_config"](arch).replace(num_layers=layers,
                                                dtype="float32")
        cpu = api.build_params(cfg, torch.Generator().manual_seed(SEED),
                               device="cpu")
        gpu = bridge.from_numpy(bridge.to_numpy(cpu), cfg, device="cuda")
        batch = api.synthesize_batch(
            cfg, m["ShapeConfig"]("p", 64 + cfg.num_patch_tokens, 2,
                                  "prefill"),
            torch.Generator().manual_seed(SEED), device="cpu")
        want, _, _ = api.forward(cpu, batch, cfg, mode="prefill")
        _zero_counts(m)
        got, _, _ = api.forward(gpu, batch, cfg, mode="prefill")
        n = _counts(m)
        E = cfg.encoder_layers
        expect = {XLSTM: (0, 1 + layers, layers),
                  WHISPER: (E + 2 * layers, 2, 2 * E + 3 * layers),
                  INTERNVL: (layers, 1, 2 * layers)}[arch]
        _check((n["flash_attention"], n["rmsnorm"], n["add_rmsnorm"])
               == expect, f"{arch}: launches {n} per prefill, want "
               f"flash, rmsnorm, add_rmsnorm {expect}")
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
           "tokens_digest": token_digest([res[r] for r in rids]),
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


def token_digest(out) -> str:
    """A digest of a path's tokens (a list of per-request token lists):
    the first 16 hex digits of the SHA-256 of their JSON, so that two
    runs can be compared by their printed lines."""
    import hashlib
    return hashlib.sha256(json.dumps(out).encode()).hexdigest()[:16]


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


def decode_vs_prefill(m, cfg, params, prompt, extra=None) -> float:
    """Cosine of prefill(L) + one decode step against the last logits of
    prefill(L + 1): for zamba2 the SSD kernel, ssd_decode_step, the conv
    state and the shared block's KV cache together; for xlstm the
    chunked mLSTM against its sequential cell; for whisper and the vlm
    backbone the flash prefill against the cached decode.  `extra`: the
    stub frontend's embeddings, given to both prefills."""
    torch, api = m["torch"], m["api"]
    extra = extra or {}
    L = len(prompt) - 1
    toks = torch.tensor([prompt])
    first, _, caches = api.forward(params, dict(extra, tokens=toks[:, :L]),
                                   cfg, mode="prefill")
    ctx = first.shape[1]            # L, or L + the patches
    caches = api.grow_caches(cfg, caches, ctx + 8)
    caches["len"] = torch.tensor([ctx], dtype=torch.int32, device="cuda")
    step, _, _ = api.forward(params, {"tokens": toks[:, L:]}, cfg,
                             mode="decode", caches=caches)
    full, _, _ = api.forward(params, dict(extra, tokens=toks), cfg,
                             mode="prefill")
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


def _build_model(m, arch, layers=None):
    """The full-width model of `arch` in bf16 from seed 0 (depth cut to
    `layers` when given), with the free memory before and the peak
    after its init printed."""
    torch = m["torch"]
    cfg = m["get_config"](arch)
    full = cfg.num_layers
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    free, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = m["api"].build_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    depth = (f"{cfg.num_layers} layers" if layers is None else
             f"{cfg.num_layers} of {full} layers (depth cut)")
    print(f"[serve] {arch} full width, {depth}, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B params "
          f"bf16, init {time.perf_counter() - t0:.3f}s; free before "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB, peak after "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return cfg, params


def forward_path(m, cfg, params, prompt, extra, steps: int = 8) -> dict:
    """The main path of a family the serving engine does not run (in
    neither package): ``api.forward`` prefill of `prompt` (with the stub
    frontend's embeddings `extra`), then `steps` greedy decode steps on
    the grown caches; every launch count zeroed just before, read just
    after.  Each step's logits must be finite."""
    torch, api = m["torch"], m["api"]
    gc.collect()
    _zero_counts(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    logits, _, caches = api.forward(params, dict(extra, tokens=toks), cfg,
                                    mode="prefill")
    ctx = logits.shape[1]
    caches = api.grow_caches(cfg, caches, ctx + steps)
    out = []
    for i in range(steps + 1):
        last = logits[0, -1].float()
        _check(bool(torch.isfinite(last).all()),
               f"{cfg.name}: non-finite logits at step {i}")
        out.append(int(last.argmax()))
        if i == steps:
            break
        logits, _, caches = api.forward(
            params, {"tokens": torch.tensor([[out[-1]]], dtype=torch.int32,
                                            device="cuda")},
            cfg, mode="decode", caches=caches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"arch": cfg.name, "mode": "api.forward",
            "layers": cfg.num_layers, "prompt_tokens": len(prompt),
            "context": ctx, "tokens": len(out), "wall_s": wall,
            "tokens_per_s": len(out) / wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "out": [out], "tokens_digest": token_digest([out]),
            "launches": _counts(m),
            "flash_launches_by_route": dict(m["fa_ops"].launches_by_route)}


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

    # the dense configs at full width and depth: qwen2.5-32b (QKV bias,
    # rope theta 1e6, ~64 GB of weights) first, on an empty card, then
    # minitron-4b (a 256000-entry vocabulary); both head_dim 128
    for key, arch in (("qwen", QWEN), ("minitron", MINITRON)):
        cfg, params = _build_model(m, arch)
        pa, pb = prompts(cfg)
        out[f"{key}_chunked"] = _serve(m, cfg, params, pa, 8,
                                       prefill_mode="chunked",
                                       prefix_cache_entries=32)
        out[f"{key}_legacy"] = _serve(m, cfg, params, pb, 8,
                                      prefill_mode="legacy")
        peaks = [out[f"{key}_{mode}"]["peak_mem_gb"]
                 for mode in ("chunked", "legacy")]
        print(f"[serve] {arch}: max_memory_allocated {peaks[0]:.2f} GB "
              f"chunked, {peaks[1]:.2f} GB legacy", flush=True)
        del params
        _free(torch)

    # olmoe-1b-7b chunked: 64 experts, top 8, no shared expert
    cfg, params = _build_model(m, OLMOE)
    pa, _ = prompts(cfg)
    out["olmoe_chunked"] = _serve(m, cfg, params, pa, 8,
                                  prefill_mode="chunked",
                                  prefix_cache_entries=32)
    del params
    _free(torch)

    # the families the serving engine does not run: prefill + 8 greedy
    # decode steps through api.forward, stub frames and patches from
    # api.synthesize_batch; a generator of their own
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for key, arch, layers in (("xlstm", XLSTM, None),
                              ("whisper", WHISPER, None),
                              ("internvl", INTERNVL, INTERNVL_LAYERS)):
        cfg, params = _build_model(m, arch, layers)
        extra = {k: v for k, v in m["api"].synthesize_batch(
            cfg, m["ShapeConfig"]("p", 64 + cfg.num_patch_tokens, 1,
                                  "prefill"), g, device="cuda").items()
            if k != "tokens"}
        prompt = rng.integers(0, cfg.vocab_size, 65).tolist()
        out[f"{key}_forward"] = forward_path(m, cfg, params, prompt[:64],
                                             extra)
        cos = decode_vs_prefill(m, cfg, params, prompt, extra)
        _check(cos >= 0.99,
               f"{arch} prefill+decode vs prefill cosine {cos}")
        out[f"{key}_decode_vs_prefill_cosine"] = cos
        if layers is not None:
            out[f"{key}_forward"]["depth_cut"] = (
                f"{layers} of {m['get_config'](arch).num_layers} layers")
        run = out[f"{key}_forward"]
        print(f"[serve] {arch} ({cfg.num_layers} layers): tokens "
              f"{run['out'][0]}, decode vs prefill cosine {cos:.6f}, peak "
              f"{run['peak_mem_gb']:.2f} GB", flush=True)
        del params, extra
        _free(torch)

    for key in ("phi3", "deepseek", "qwen", "minitron", "olmoe"):
        _check(out[f"{key}_chunked"]["prefix_cache_hits"] > 0,
               f"no prefix-cache hit in {key} chunked")
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
              "zamba_legacy": norms + ("flash_attention", "ssd_intra"),
              "qwen_chunked": norms,
              "qwen_legacy": norms + ("flash_attention",),
              "minitron_chunked": norms,
              "minitron_legacy": norms + ("flash_attention",),
              "olmoe_chunked": norms + ("moe_dispatch",),
              "xlstm_forward": norms,
              "whisper_forward": norms + ("flash_attention",),
              "internvl_forward": norms + ("flash_attention",)}
    for path, names in expect.items():
        for name in names:
            _check(out[path]["launches"][name] > 0,
                   f"no {name} launch in {path}")
        # bf16 serving runs flash on the tensor-core route only
        _check(out[path]["flash_launches_by_route"]
               == {"wgmma": out[path]["launches"]["flash_attention"],
                   "fma": 0},
               f"{path}: flash routes {out[path]['flash_launches_by_route']}")
    out["tokens_digests"] = {p: v["tokens_digest"] for p, v in out.items()
                             if isinstance(v, dict) and "tokens_digest" in v}
    print(f"[serve] tokens digests: {json.dumps(out['tokens_digests'])}",
          flush=True)
    return out


LONG_DECODE = 8    # decode steps past the long-context prefill
# long-context decode vs the windowed prefill, fp32: 1 - cosine is
# rounding only (bf16 is printed, not held: at 4096 tokens two bf16
# prefills of the same tokens already differ at one position by more
# than 0.99 allows: experiments/long_context_cosines.py)
LONG_COS_FP32 = 0.9999


def _long_context_run(m, cfg, params, prompt) -> dict:
    """``api.forward(long_context=True)``: a prefill of exactly one
    window of `prompt` tokens (each shared-attention cache a ring of
    that many slots, not grown), then LONG_DECODE greedy decode steps,
    the first writing slot 0; then one windowed prefill of the prompt
    and the decoded tokens (window + LONG_DECODE of them), whose logits
    at the decoded positions are what each step must give: a causal
    model's logits at a position read no later token, and the prefill's
    window drops the keys the ring has overwritten.  Every launch count
    is zeroed just before the first prefill and read just after the
    last decode step."""
    torch, api = m["torch"], m["api"]
    W = api.ZAMBA_LONG_WINDOW
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(m)
    t0 = time.perf_counter()
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    logits, _, caches = api.forward(params, {"tokens": toks}, cfg,
                                    mode="prefill", long_context=True)
    ring = tuple(caches["kv"]["k"].shape)
    _check(ring[2] == W, f"long-context caches {ring}: want a ring of {W}")
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    out, steps = [], []
    for i in range(LONG_DECODE + 1):
        last = logits[0, -1].float()
        _check(bool(torch.isfinite(last).all()),
               f"zamba2 long-context {cfg.dtype}: non-finite logits at "
               f"step {i}")
        out.append(int(last.argmax()))
        if i:
            steps.append(last)
        if i == LONG_DECODE:
            break
        logits, _, caches = api.forward(
            params, {"tokens": torch.tensor([[out[-1]]], dtype=torch.int32,
                                            device="cuda")},
            cfg, mode="decode", caches=caches, long_context=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(m)
    routes = dict(m["fa_ops"].launches_by_route)
    _check(int(caches["len"]) == W + LONG_DECODE
           and tuple(caches["kv"]["k"].shape) == ring,
           f"long-context caches after decode: len {int(caches['len'])}, "
           f"{tuple(caches['kv']['k'].shape)}")
    rec = {"dtype": cfg.dtype, "ring": list(ring), "tokens": len(out),
           "ttft_s": ttft, "wall_s": wall, "tokens_per_s": len(out) / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "out": [out], "tokens_digest": token_digest([out]),
           "launches": counts, "flash_launches_by_route": routes}
    del caches, logits
    seq = torch.tensor([prompt + out[:LONG_DECODE]], dtype=torch.int32,
                       device="cuda")
    want, _, _ = api.forward(params, {"tokens": seq}, cfg, mode="prefill",
                             long_context=True)
    rec["decode_vs_prefill_cosine"] = [
        _cosine(torch, got, want[0, W + i]) for i, got in enumerate(steps)]
    return rec


def long_context_phase(m) -> dict:
    """zamba2-7b at full width and depth with the long-context cell's
    windowed shared attention (window ``api.ZAMBA_LONG_WINDOW``), in
    bf16 (the path: every launch count zeroed just before its prefill,
    read just after its last decode step) and again in fp32 from the
    same seed, each through ``_long_context_run``: 4096 tokens fill the
    rings and 8 decode steps wrap them (the bf16 run's launch counts
    are the path's).  The fp32 steps' logits must be within cosine
    LONG_COS_FP32 of the windowed prefill's; the bf16 cosines are
    printed."""
    torch, np, api = m["torch"], m["np"], m["api"]
    cfg, params = _build_model(m, ZAMBA)
    W = api.ZAMBA_LONG_WINDOW
    prompt = np.random.default_rng(SEED + 24).integers(
        0, cfg.vocab_size, W).tolist()
    rec = _long_context_run(m, cfg, params, prompt)
    counts, routes = rec["launches"], rec["flash_launches_by_route"]
    del params
    _free(torch)
    cfg32 = cfg.replace(dtype="float32")
    params = api.build_params(
        cfg32, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    rec["fp32"] = _long_context_run(m, cfg32, params, prompt)
    rec.update(arch=cfg.name, mode="api.forward long_context",
               layers=cfg.num_layers, window=W, prompt_tokens=W)
    print(f"[serve] {cfg.name} long-context (window {W}, ring "
          f"{rec['ring']}): bf16 tokens {rec['out'][0]}, ttft "
          f"{rec['ttft_s']:.3f}s, peak {rec['peak_mem_gb']:.2f} GB, decode "
          f"vs windowed prefill cosines bf16 "
          f"{[round(c, 6) for c in rec['decode_vs_prefill_cosine']]}, fp32 "
          f"{rec['fp32']['decode_vs_prefill_cosine']}", flush=True)
    cos = rec["fp32"]["decode_vs_prefill_cosine"]
    _check(min(cos) >= LONG_COS_FP32,
           f"zamba2 long-context fp32 decode vs windowed prefill cosines "
           f"{cos}")
    for name in ("rmsnorm", "add_rmsnorm", "flash_attention", "ssd_intra"):
        _check(counts[name] > 0, f"no {name} launch in zamba2 long-context")
    _check(routes == {"wgmma": counts["flash_attention"], "fma": 0},
           f"zamba2 long-context: flash routes {routes}")
    del params
    _free(torch)
    return rec


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
    # the flash calls the new paths add: whisper's encoder (non-causal,
    # S 1500) and cross-attention (64 queries on 1500 keys), qwen's and
    # internvl's legacy buckets (D 128, GQA); SDPA does the same GQA
    # attention with enable_gqa.  Marked "new" (not main-path shapes)
    for S, Sk, H, KV, D, causal in ((1500, 1500, 6, 6, 64, False),
                                    (64, 1500, 6, 6, 64, False),
                                    (128, 128, 40, 8, 128, True),
                                    (320, 320, 64, 8, 128, True)):
        q = torch.randn(1, S, H, D, generator=g, device="cuda").to(bf)
        k = torch.randn(1, Sk, KV, D, generator=g, device="cuda").to(bf)
        v = torch.randn(1, Sk, KV, D, generator=g, device="cuda").to(bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2 if causal else S * Sk
        out["flash_attention"].append({
            "shape": [[1, S, H, D], [1, Sk, KV, D]], "dtype": "bfloat16",
            "causal": causal, "new": True,
            **_times(torch,
                     lambda: m["fa_ops"].flash_attention_cuda(
                         q, k, v, causal=causal),
                     lambda: m["attention_ref"](q, k, v, causal=causal),
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=causal,
                         enable_gqa=KV != H)),
            **_bound(2 * (2 * S * H * D + 2 * Sk * KV * D),
                     4 * D * pairs * H, BF16_FLOPS)})
        del q, k, v, qt, kt, vt
    for rows, d in ((1500, 384), (128, 5120), (320, 8192)):
        x = torch.randn(rows, d, generator=g, device="cuda").to(bf)
        s = torch.randn(d, generator=g, device="cuda").to(bf)
        out["rmsnorm"].append({
            "shape": [rows, d], "dtype": "bfloat16", "new": True,
            **_times(torch, lambda: m["rms_ops"].rmsnorm_cuda(x, s),
                     lambda: m["rmsnorm_ref"](x, s),
                     lambda: F.rms_norm(x, (d,), s, 1e-5)),
            **_bound(2 * (2 * rows * d + d), 4 * rows * d, FP32_FLOPS)})
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
# training: h2o-danube-1.8b, the backward kernels
# ---------------------------------------------------------------------------

DANUBE = "h2o-danube-1.8b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 8192, 2, 1, 3
# Adam's first steps move every weight by about lr: at the CLI's default
# 3e-4 with one warm-up step, the random full-width weights overshoot
# and the loss rose over 3 steps (11.31, 12.79, 15.95 on an H100); the
# run takes a tenth of that
TRAIN_LR = 3e-5
# danube's attention and norm at full width: [1, 8192, 32, 80] queries
# against 8 kv heads under its 4096 window; [8192, 2560] norm rows
FLASH_BWD_SHAPE = (1, TRAIN_SEQ, 32, 8, 80, 4096)
# danube's heads at S 4096: its 4096 window cannot bind, so the kernel
# and SDPA's causal backward (the yardstick) do the same pairs
SAME_WORK_SHAPE = (1, 4096, 32, 8, 80, 4096)
NORM_BWD_SHAPE = (TRAIN_SEQ, 2560)
# normalized error max |got - want| / max |want|: bf16 outputs of both
# versions are fp32 sums rounded once (one bf16 ulp is 2^-8 of an
# element); fp32 differs only in the order of the sums
BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# the forward kernels at the train shapes, as kernel_phase holds them
# (|got - want| <= tol + tol |want|): flash, then the two norm forms
FWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 1e-5)}


def _rel_err(torch, got, want, tol: float, what: str) -> tuple:
    """(max abs error, normalized error); fails above `tol` normalized
    or on a non-finite output."""
    g, w = got.float(), want.float()
    _check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = float((g - w).abs().max())
    rel = err / max(float(w.abs().max()), 1e-30)
    _check(rel <= tol, f"{what}: normalized error {rel} above {tol}")
    return err, rel


def _pairs(S: int, window) -> int:
    """(query, key) pairs on the causal / window mask."""
    w = window or S
    return sum(min(i + 1, w) for i in range(S))


def flash_bwd_inputs(torch, g, B, S, H, KV, D, dt):
    q, k, v, do = (torch.randn(B, S, h, D, generator=g, device="cuda")
                   .to(dt) for h in (H, KV, KV, H))
    return q, k, v, do


def _norm_check(m, g, rows: int, d: int, dt, out: dict) -> None:
    """The RMSNorm forward (FWD_TOL; the fused form's sum bit-exact) and
    the backward, plain and fused form, against their plain versions on
    [rows, d] inputs in `dt`: dx (dh) and dscale within BWD_TOL
    normalized, two backward runs the same bits.  The backward's errors
    go into out["rmsnorm_bwd"] / out["add_rmsnorm_bwd"], the forward's
    worst into out["forward"]."""
    torch, rms = m["torch"], m["rms_ops"]
    name = str(dt).replace("torch.", "")
    tol, norm_tol, fwd = BWD_TOL[name], FWD_TOL[name][1], out["forward"]
    x, dy, ds = (torch.randn(rows, d, generator=g, device="cuda").to(dt)
                 for _ in range(3))
    sc = torch.randn(d, generator=g, device="cuda").to(dt)
    what = f"{name} [{rows},{d}]"
    y = rms.rmsnorm_cuda(x, sc)
    s2, y2 = rms.add_rmsnorm_cuda(x, ds, sc)
    torch.cuda.synchronize()
    fwd["rmsnorm"] = max(fwd.get("rmsnorm", 0.0), _max_err(
        torch, y, m["rmsnorm_ref"](x, sc), norm_tol, f"rmsnorm {what}"))
    _check(torch.equal(s2, x + ds), f"add_rmsnorm {what}: sum not bit-exact")
    fwd["add_rmsnorm"] = max(fwd.get("add_rmsnorm", 0.0), _max_err(
        torch, y2, m["rmsnorm_ref"](x + ds, sc), norm_tol,
        f"add_rmsnorm {what}"))
    del y, s2, y2
    for kname, fused in (("rmsnorm_bwd", False), ("add_rmsnorm_bwd", True)):
        got = rms.rmsnorm_bwd_cuda(x, ds if fused else None, dy, sc)
        again = rms.rmsnorm_bwd_cuda(x, ds if fused else None, dy, sc)
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(got, again)),
               f"{kname} {what}: two runs differ")
        want = (m["add_rmsnorm_bwd_ref"](x, ds, dy, sc) if fused
                else m["rmsnorm_bwd_ref"](x, sc, dy))
        for grad, a, b in zip(("dx", "dscale"), got, want):
            err, rel = _rel_err(torch, a, b, tol, f"{kname} {what} {grad}")
            rec = out[kname]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["normalized_err"][f"{kname} {what} {grad}"] = rel


def train_kernel_phase(m) -> dict:
    """Each backward kernel against its plain version on the same
    inputs, in bf16 and fp32: flash at danube's full width (S 8192,
    window 4096, so the window binds) and at a short ragged S with and
    without a window; the norms at danube's [8192, 2560] rows and a
    short block, both forms.  Two runs of each must give the same bits.
    The forward kernels are held against their plain versions at the
    same shapes (FWD_TOL; the fused norm's sum bit-exact): the forward's
    output must be the same bits with and without the LSE, and the LSE
    within 1e-4 of the plain one.  Their worst errors are returned under
    ``forward``."""
    torch = m["torch"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {name: {"max_abs_err": 0.0, "normalized_err": {}}
           for name in ("flash_attention_bwd", "rmsnorm_bwd",
                        "add_rmsnorm_bwd")}
    fwd = out["forward"] = {"flash_attention": 0.0, "rmsnorm": 0.0,
                            "add_rmsnorm": 0.0}
    B, S, H, KV, D, W = FLASH_BWD_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        for s_len, w in ((S, W), (200, 64), (130, None)):
            _, e = _flash_bwd_check(m, g, (B, s_len, H, KV, D, w), dt,
                                    out["flash_attention_bwd"])
            fwd["flash_attention"] = max(fwd["flash_attention"], e)
        for rows, d in (NORM_BWD_SHAPE, (33, 2560)):
            _norm_check(m, g, rows, d, dt, out)
    return out


def _train_setup(m, cfg, tc, device, params=None, seq=64, batch=2):
    state = m["train_loop"].init_train_state(cfg, tc, device=device,
                                             params=params)
    shape = m["ShapeConfig"]("t", seq_len=seq, global_batch=batch,
                             kind="train")
    loader = m["Loader"](m["SyntheticLM"](cfg, shape, seed=tc.seed),
                         device=device, model_dtype=state.params.embed.dtype)
    return state, m["train_loop"].make_train_step(cfg, tc), loader


def card_vs_cpu_step(m, cfg, grad_floor: float = 0.0,
                     vanishing=()) -> dict:
    """One fp32 train step of `cfg` (remat full) on the card against
    the same step on the CPU, same weights and batch (kernels vs plain
    versions): the loss to 1e-5, every grad leaf to 1e-4 of its largest
    entry (the leaves in `vanishing`, whose grads are zero but for
    rounding, to 1e-4 of the largest entry of any leaf), the grad norm
    to 1e-4, and the updated params to 2e-5 where
    the clipped CPU grad |g'| > 100 eps and > `grad_floor` times its
    leaf's largest |g'|.
    Adam's first step moves a weight by lr g' / (|g'| + eps): by about
    lr wherever |g'| >> eps, and a rounding difference dg of the grad
    moves that by lr eps |dg| / g'^2, far below 2e-5 there; where |g'|
    is within the grads' own rounding of 0, that rounding can flip the
    step's sign, so those weights are left out and their share
    reported.  For an MoE config, the dispatch's slots are recorded at
    each call: the recomputation of a layer in the backward must route
    as its first forward did."""
    torch, tl, bridge = m["torch"], m["train_loop"], m["bridge"]
    tc = m["TrainConfig"](warmup_steps=2, total_steps=10, remat="full")
    cpu, step_c, load_c = _train_setup(m, cfg, tc, "cpu")
    model = bridge.from_numpy(bridge.to_numpy(cpu.params), cfg,
                              device="cuda")
    gpu, step_g, _ = _train_setup(m, cfg, tc, "cuda", params=model)
    acc = tl._make_accumulate(cfg, tc)
    batch = next(load_c)
    batch_g = {k: v.cuda() for k, v in batch.items()}
    grads_c, met_c = acc(cpu.params, batch)
    slots = []
    dispatch = m["moe_mod"].moe_dispatch

    def recorded(eidx, x, E, C):
        got = dispatch(eidx, x, E, C)
        slots.append(got[1].clone())
        return got

    m["moe_mod"].moe_dispatch = recorded
    try:
        _zero_counts(m)
        grads_g, met_g = acc(gpu.params, batch_g)
        torch.cuda.synchronize()
        n = _counts(m)
    finally:
        m["moe_mod"].moe_dispatch = dispatch
    if cfg.is_moe:
        # remat full: layers 0..L-1 forward, then L-1..0 recomputed
        _check(len(slots) == 2 * n["moe_dispatch_bwd"] and all(
            torch.equal(a, b) for a, b in zip(slots, slots[::-1])),
            f"{cfg.name}: the recomputed dispatch routed otherwise")
    loss_err = abs(float(met_g["loss"]) - float(met_c["loss"])) \
        / abs(float(met_c["loss"]))
    _check(loss_err <= 1e-5,
           f"{cfg.name} reduced step loss: relative error {loss_err}")
    worst = 0.0
    largest = max(float(g.abs().max()) for g in grads_c.values())
    for name, want in grads_c.items():
        what = f"{cfg.name} reduced step grad {name}"
        if name in vanishing:
            err = float((grads_g[name].cpu() - want).abs().max())
            _check(err <= 1e-4 * largest, f"{what}: error {err} above 1e-4 "
                   f"of the largest grad entry {largest}")
            continue
        _, rel = _rel_err(torch, grads_g[name].cpu(), want, 1e-4, what)
        worst = max(worst, rel)
    cpu2, mc = step_c(cpu, batch)
    gpu2, mg = step_g(gpu, batch_g)
    gn_err = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        / float(mc["grad_norm"])
    _check(gn_err <= 1e-4,
           f"{cfg.name} reduced step grad norm: relative {gn_err}")
    clip = min(1.0, tc.grad_clip / float(mc["grad_norm"]))
    on_gpu = dict(gpu2.params.named_parameters())
    diffs, kept = [], []
    for name, p in cpu2.params.named_parameters():
        diffs.append((on_gpu[name].detach().cpu() - p.detach()).abs()
                     .flatten())
        g = grads_c[name].abs() * clip
        kept.append(((g > 100 * tc.eps) & (g > grad_floor * g.max()))
                    .flatten())
    diffs, kept = torch.cat(diffs), torch.cat(kept)
    perr = float(diffs[kept].max())
    left_out = float((~kept).float().mean())
    _check(perr <= 2e-5,
           f"{cfg.name} reduced step params: max abs error {perr} where "
           f"|g'| is kept ({left_out} of them left out)")
    return {"loss": [float(met_g["loss"]), float(met_c["loss"])],
            "loss_rel_err": loss_err, "grad_worst_normalized_err": worst,
            "grad_norm_rel_err": gn_err, "params_max_abs_err": perr,
            "params_share_left_out": left_out, "launches": n,
            "dispatch_calls_routed_alike": len(slots)}


def train_reduced_phase(m) -> dict:
    """Reduced danube (window 16, S 64 > window) on the card: one fp32
    step against the same step on the CPU (kernels vs plain versions:
    loss, grad norm, every grad leaf, the updated params); 30 bf16 steps
    on one fixed batch (the loss must fall below 0.7x its first value);
    and the chaos resume (crashes and corrupt checkpoints of
    ``faults.training_plan(2)``) against a fault-free run, bit for bit."""
    torch = m["torch"]
    TC = m["TrainConfig"]
    out = {}
    # (a) one fp32 step, card vs CPU; the card runs the kernels (remat
    # full: every forward kernel twice, every backward kernel once)
    cfg = m["reduced_config"](DANUBE).replace(dtype="float32")
    out["card_vs_cpu"] = card_vs_cpu_step(m, cfg)
    n, L = out["card_vs_cpu"]["launches"], cfg.num_layers
    # layer 0's first norm has no residual to add (the plain form); the
    # final norm's sum is unused, so its backward takes no ds
    _check(n["flash_attention"] == 2 * L and n["flash_attention_bwd"] == L
           and n["rmsnorm"] == 2 and n["add_rmsnorm"] == 4 * L - 1
           and n["rmsnorm_bwd"] == 2 and n["add_rmsnorm_bwd"] == 2 * L - 1,
           f"reduced fp32 step launches {n}")

    # (b) 30 bf16 steps on one fixed batch, as tests/test_system.py's
    # test_loss_decreases_tiny_model asks of the JAX trainer
    cfg = m["reduced_config"](DANUBE).replace(num_layers=2)
    tc = TC(learning_rate=1e-3, warmup_steps=2, total_steps=30,
            remat="none")
    st, step, loader = _train_setup(m, cfg, tc, "cuda", seq=64, batch=2)
    batch = next(loader)
    losses = []
    for _ in range(30):
        st, met = step(st, batch)
        losses.append(float(met["loss"]))
    _check(all(map(math.isfinite, losses)) and losses[-1]
           < 0.7 * losses[0], f"reduced danube loss {losses[0]} -> "
           f"{losses[-1]} (must fall below 0.7x)")
    out["loss_30_steps"] = [losses[0], losses[-1]]
    del st

    # (c) the chaos resume: crashes at step polls 4, 6, 9 and corrupt
    # checkpoints at saves 3 and 7 of training_plan(2); every step
    # checkpoints, a crash restores the newest verified one
    cfg = m["reduced_config"](DANUBE).replace(num_layers=2)
    tc = TC(total_steps=10, warmup_steps=1, learning_rate=1e-3)
    st, step, loader = _train_setup(m, cfg, tc, "cuda", seq=64, batch=2)
    ref, _ = m["train_with_recovery"](st, step, loader, total_steps=10)
    st, step, loader = _train_setup(m, cfg, tc, "cuda", seq=64, batch=2)
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    if ckdir.exists():
        shutil.rmtree(ckdir)
    inj = m["faults"].FaultInjector(m["faults"].training_plan(2,
                                                               horizon=10))
    mgr = m["CheckpointManager"](str(ckdir), keep=3, injector=inj)
    got, restarts = m["train_with_recovery"](
        st, step, loader, total_steps=10, manager=mgr, checkpoint_every=1,
        injector=inj, max_restarts=4, backoff_base_s=0.0)
    shutil.rmtree(ckdir)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(ref.params.named_parameters(),
                   got.params.named_parameters()))
    same = same and all(torch.equal(ref.opt.master[k], got.opt.master[k])
                        for k in ref.opt.master)
    _check(restarts == 3 and inj.remaining() == 0 and same
           and int(got.opt.step) == 10,
           f"chaos resume: restarts {restarts}, faults left "
           f"{inj.remaining()}, bit-equal {same}")
    out["chaos_resume"] = {"restarts": restarts, "bit_equal": same}
    return out


def train_cli_phase(m) -> dict:
    """Full-width h2o-danube-1.8b through ``launch.train.main``: bf16,
    random weights from seed 0, seq 8192 (the 4096 window binds), batch
    2 in microbatches of 1, remat full (the default), lr TRAIN_LR,
    TRAIN_STEPS steps.
    Every step's loss and grad norm must be finite and > 0; the kernels'
    launches on this path are counted."""
    torch = m["torch"]
    argv = ["--arch", DANUBE, "--device", "cuda", "--steps",
            str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--microbatch", str(TRAIN_MICRO), "--lr",
            str(TRAIN_LR), "--log-every", "1"]
    hist = []
    _zero_counts(m)
    t0 = time.perf_counter()
    _check(m["train_cli"].main(argv, history=hist) == 0, "train CLI failed")
    wall = time.perf_counter() - t0
    counts = _counts(m)
    _check(len(hist) == TRAIN_STEPS and all(
        math.isfinite(h["loss"]) and h["loss"] > 0
        and math.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
        for h in hist), f"full-width danube steps: {hist}")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    steps = [{"step": h["step"], "loss": h["loss"],
              "grad_norm": h["grad_norm"], "step_ms": 1e3 * h["step_s"],
              "tokens_per_s": tokens / h["step_s"],
              "peak_gb": h["peak_gb"]} for h in hist]
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "add_rmsnorm", "rmsnorm_bwd", "add_rmsnorm_bwd"):
        _check(counts[name] > 0, f"no {name} launch in the train path")
    routes = dict(m["fa_ops"].launches_by_route)
    _check(routes == {"wgmma": counts["flash_attention"], "fma": 0},
           f"bf16 training ran flash on routes {routes}")
    _free(torch)
    return {"wall_s": wall, "steps": steps, "launches": counts,
            "flash_launches_by_route": routes}


def _profiled_step(m, step, st, batch) -> tuple:
    """One train step under ``torch.profiler``: (the new state, wall,
    device ms, busy share, the host's ms and share of the wall in the
    SLSTM_RANGE ranges and their backward, kernels, host syncs, the
    kernels with most device time, each hand-written kernel's device ms
    and launches, and the backward kernels' share of device time)."""
    torch = m["torch"]
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, met = step(st, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _check(math.isfinite(float(met["loss"])), "profiled step: loss")
    # the raw events, summed by name here: the profiler's own summary
    # (key_averages) builds a Python object an event, minutes for the
    # ~2M events of an xlstm step (its sLSTM loop)
    cuda = torch.autograd.DeviceType.CUDA
    kern, counts, ranges, ops, bwd = {}, {}, [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        counts[name] = counts.get(name, 0) + 1
        if name == SLSTM_RANGE:     # the device side of a range is no
            if e.device_type() != cuda:                     # kernel
                ranges.append((e.start_ns(), e.end_ns()))
        elif e.device_type() == cuda and e.duration_ns() > 0:
            t, n = kern.get(name, (0, 0))
            kern[name] = (t + e.duration_ns(), n + 1)
        elif name.startswith("autograd::engine::evaluate_function"):
            bwd.append((e.sequence_nr(), e.start_ns(), e.end_ns()))
        elif e.sequence_nr() >= 0:
            ops.append((e.sequence_nr(), e.start_ns()))
    dev = sum(t for t, _ in kern.values()) / 1e6
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    ours = {k: [sum(t for name, (t, _) in kern.items()
                    if re.search(pat, name)) / 1e6,
                sum(n for name, (_, n) in kern.items()
                    if re.search(pat, name))]
            for k, pat in OUR_KERNELS.items()}
    bwd_ms = sum(ours[k][0] for k in (
        "flash_attention_bwd", "rmsnorm_bwd (both forms)",
        "moe_dispatch_bwd", "ssd_intra_bwd"))
    n_kernels = sum(n for _, n in kern.values())
    syncs = {key: counts.get(key, 0)
             for key in ("aten::_local_scalar_dense",
                         "cudaStreamSynchronize")}
    # which RMSNorm backward instance (template arguments) each width
    # picked, by launches
    norm_bwd = {}
    for name, (_, n) in kern.items():
        inst = re.search(r"rmsnorm_bwd_kernel<[^>]*>", name)
        if inst:
            norm_bwd[inst.group(0)] = norm_bwd.get(inst.group(0), 0) + n
    # the host's time in the sLSTM ranges (the blocks' forwards and
    # their recomputes) and in the backward of the ops they recorded,
    # matched by autograd sequence number; the loop is host-bound (a
    # step a token), so this is its share of the step's wall
    ranges.sort()
    starts = [a for a, _ in ranges]
    seqs = {n for n, t in ops if (i := bisect.bisect(starts, t) - 1) >= 0
            and t < ranges[i][1]}
    spans = sorted(ranges + [(a, b) for n, a, b in bwd if n in seqs])
    slstm_ns, end = 0, 0
    for a, b in spans:              # their union: a recompute nests in
        slstm_ns += max(0, b - max(a, end))     # a backward node's span
        end = max(end, b)
    out = {"wall_ms": wall, "device_ms": dev, "busy_share": dev / wall,
           "slstm": {"ranges": len(ranges), "ms": slstm_ns / 1e6,
                     "share": slstm_ns / 1e6 / wall},
           "kernels": n_kernels, "rmsnorm_bwd_instances": norm_bwd,
           "host_syncs": syncs,
           "top": [[name[:60], t / 1e6, n] for name, (t, n) in top],
           "ours": ours, "backward_kernels_ms": bwd_ms,
           "backward_kernels_share": bwd_ms / dev}
    del prof, kern
    return st, out


def train_profile(m) -> dict:
    """One full-width train step (after one warm-up step) under
    ``torch.profiler`` (``_profiled_step``)."""
    torch = m["torch"]
    cfg = m["get_config"](DANUBE)
    tc = m["TrainConfig"](microbatch=TRAIN_MICRO, remat="full")
    st, step, loader = _train_setup(m, cfg, tc, "cuda", seq=TRAIN_SEQ,
                                    batch=TRAIN_BATCH)
    st, _ = step(st, next(loader))
    batch = next(loader)
    st, out = _profiled_step(m, step, st, batch)
    del st, batch
    _free(torch)
    return out


def train_timing(m) -> dict:
    """Each backward kernel at danube's full-width shapes (bf16), its
    plain version and the library yardstick, and the kernel's bound.
    Flash (calls of 2-70 ms): CUDA events around eager calls; the host's
    share is well under 1% for the kernel, a few % for the yardstick's
    autograd call (the profiler dropped some of these long kernels'
    events in one run, reading 30 ms for a 44 ms kernel).  The norms
    (~0.05 ms): the kernel and its plain version as CUDA-graph replays,
    the yardstick (autograd's backward cannot be captured) as the sum
    of its kernels' device times under the profiler; ``*call_ms`` are
    CUDA events around eager calls, host included.
    Yardsticks, timed only and never on the path: flash, the backward of
    ``scaled_dot_product_attention`` at S 8192 causal with no window
    (it takes no window; its kv heads repeated to 32), and on the same
    work at SAME_WORK_SHAPE, where the 4096 window cannot bind, so the
    kernel and SDPA's causal backward do the same pairs (``same_work``);
    the norms, the backward of ``F.rms_norm`` (after ``torch.add`` for
    the fused form)."""
    torch, F, fa, rms = m["torch"], m["F"], m["fa_ops"], m["rms_ops"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf = torch.bfloat16
    out = {}
    flash = {}
    for key, (B, S, H, KV, D, W) in (("", FLASH_BWD_SHAPE),
                                     ("same_work", SAME_WORK_SHAPE)):
        q, k, v, do = flash_bwd_inputs(torch, g, B, S, H, KV, D, bf)
        o, lse = fa.flash_attention_cuda(q, k, v, window=W, with_lse=True)
        qt, kt, vt = (t.transpose(1, 2).repeat_interleave(H // t.shape[2], 1)
                      .detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        kernel = lambda: fa.flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, o, lse, do, window=W)
        plain = lambda: m["flash_bwd_ref"](  # noqa: E731
            q, k, v, o, lse, do, window=W)
        library = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qt, kt, vt), dot, retain_graph=True)
        pairs = _pairs(S, W)
        row = {
            "shape": [B, S, H, KV, D], "window": W, "dtype": "bfloat16",
            "pairs": pairs, "library_pairs": _pairs(S, None),
            "ms": _time_ms(torch, kernel, reps=5, inner=4),
            "library_ms": _time_ms(torch, library, reps=5, inner=4),
            # necessary work: S, dP, dV, dQ, dK products, 2 D flops each
            # per pair and head (the kernel recomputes S and dP: 14 D)
            **_bound(2 * (4 * S * H * D + 4 * S * KV * D) + 4 * B * H * S,
                     10 * D * pairs * H, BF16_FLOPS)}
        if key:
            flash[key] = row
        else:
            row["plain_ms"] = _time_ms(torch, plain, reps=3, inner=1)
            flash.update(row)
        del q, k, v, do, o, lse, qt, kt, vt, lib_out, dot
    out["flash_attention_bwd"] = flash
    rows, d = NORM_BWD_SHAPE
    x, h, dy, ds = (torch.randn(rows, d, generator=g, device="cuda").to(bf)
                    for _ in range(4))
    sc = torch.randn(d, generator=g, device="cuda").to(bf)
    xg, hg, scg = (t.detach().requires_grad_() for t in (x, h, sc))
    y1 = F.rms_norm(xg, (d,), scg, 1e-5)
    s2 = torch.add(xg, hg)
    y2 = F.rms_norm(s2, (d,), scg, 1e-5)
    for kname, fused in (("rmsnorm_bwd", False), ("add_rmsnorm_bwd", True)):
        kernel = (lambda f=fused: rms.rmsnorm_bwd_cuda(
            x, ds if f else None, dy, sc))
        plain = (lambda f=fused: m["add_rmsnorm_bwd_ref"](x, ds, dy, sc)
                 if f else m["rmsnorm_bwd_ref"](x, sc, dy))
        library = (lambda f=fused: torch.autograd.grad(
            (s2, y2), (xg, hg, scg), (ds, dy), retain_graph=True) if f
            else torch.autograd.grad(y1, (xg, scg), dy, retain_graph=True))
        n_in = 3 if fused else 2                # x (s), dy, [ds]
        out[kname] = {
            "shape": [rows, d], "dtype": "bfloat16",
            "ms": _device_ms(torch, kernel),
            "plain_ms": _device_ms(torch, plain),
            "library_ms": _profiled_ms(torch, library),
            "call_ms": _time_ms(torch, kernel),
            "plain_call_ms": _time_ms(torch, plain),
            "library_call_ms": _time_ms(torch, library),
            **_bound(2 * ((n_in + 1) * rows * d + 2 * d),
                     9 * rows * d, FP32_FLOPS)}
    return out


# ---------------------------------------------------------------------------
# training the MoE and hybrid families: olmoe-1b-7b, deepseek-moe-16b,
# zamba2-7b, the dispatch's and SSD's backward kernels
# ---------------------------------------------------------------------------

# full width with the depth cut.  A step holds ~20 B a parameter (bf16
# weights and grads, fp32 master, m, v and grad accumulator), beside
# the activations of one recomputed layer or group at seq 4096: full
# depth would need ~140 GB (olmoe) and ~135 GB (zamba2).  At 8 of 16
# olmoe layers a step peaked at 79.92 GB, and zamba2 at 39 of 81 blocks
# ran out of memory in its second step, so the cut is one olmoe layer
# and one zamba2 group deeper: max_memory_allocated stays under ~75 GB
MOE_TRAIN = (OLMOE, 7)           # 7 of 16 layers
HYBRID_TRAIN = (ZAMBA, 33)       # 5 groups of 6 + the shared block, tail 3
# the xlstm, audio and vlm families: xlstm-125m and whisper-tiny
# at full depth; the internvl2-76b backbone's untied embedding and head
# are 2.10B parameters and each layer ~0.86B, so at ~20 B of training
# state a parameter (bf16 weights and grads, fp32 master, Adam moments
# and accumulated grads) one layer takes ~59 GB and two ~76 GB before
# activations: 1 of 80 layers
NEW_TRAIN = {"train_xlstm": (XLSTM, 12), "train_whisper": (WHISPER, 4),
             "train_internvl": (INTERNVL, 1)}
FAMILY_SEQ = 4096
# xlstm-125m trains on 2048 tokens: its sLSTM steps one token at a time
# from the host (~1M launches a step at 4096, 220-320 s of the run's
# 1200 s for 3 steps and the profiled one), and no depth cut shortens
# that (its one sLSTM block is layer 8 of 12)
FAMILY_SEQ_OF = {XLSTM: 2048}
SLSTM_RANGE = "xlstm.slstm_forward"   # the profiled step's sLSTM range
# the dispatch's backward at olmoe's (top-8) and deepseek's (top-6)
# widths: decode, chunk and a train step's token counts
DISPATCH_BWD_TS = (1, 64, FAMILY_SEQ)
# SSD at zamba2's train shape (seq 4096 in chunks of 256) and a prefill
# chunk: (nc, Q); H 112, P 64, N 64
SSD_BWD_SHAPES = ((16, 256), (1, 64))
SSD_BWD_TOL = 1e-4               # max |got - want| / max |want|, vs fp64
# flash at the families' head dims: olmoe (16 heads, D 128, no GQA) and
# zamba2's shared block (32 heads, D 112), causal, no window
FLASH_BWD_FAMILY = {"olmoe D128": (1, FAMILY_SEQ, 16, 16, 128, None),
                    "zamba2 D112": (1, FAMILY_SEQ, 32, 32, 112, None)}
# the new families' attention: (B, S, H, KV, D, window), causal,
# Sk (None: S): whisper-tiny's encoder over its 1500 frames, its
# cross-attention (4096 decoder positions on the 1500 encoder ones) and
# its decoder; the internvl2-76b backbone's heads (D 128, 8 query heads
# to a kv head); and ragged tiles on both sides
FLASH_BWD_NEW = {
    "whisper encoder": ((1, 1500, 6, 6, 64, None), False, None),
    "whisper cross": ((1, FAMILY_SEQ, 6, 6, 64, None), False, 1500),
    "whisper decoder": ((1, FAMILY_SEQ, 6, 6, 64, None), True, None),
    "internvl D128 GQA8": ((1, FAMILY_SEQ, 64, 8, 128, None), True, None),
    "odd": ((1, 130, 4, 2, 64, None), False, 77)}
# long-context zamba2's shared attention (D 112, window 4096) at the
# length of the long-context path's longest prefill
FLASH_WINDOW_NEW = (1, 4104, 32, 32, 112, 4096)
# the new families' norm rows and widths: xlstm-125m's d 768 and
# whisper-tiny's d 384 (the backward's `<bf16,1>` instance, which
# danube's d 2560 does not run) on a microbatch's 4096 rows, whisper's
# 1500 encoder rows, and the internvl2-76b backbone's d 8192 (256
# threads a row; danube's 2560 runs 128)
NORM_BWD_FAMILY = ((FAMILY_SEQ, 768), (FAMILY_SEQ, 384), (1500, 384),
                   (FAMILY_SEQ, 8192))


def _flash_bwd_check(m, g, shape, dt, out: dict, label: str = "",
                     causal: bool = True, Sk=None) -> tuple:
    """flash forward (out bits with and without the LSE; out and LSE vs
    plain, FWD_TOL and 1e-4) and the FA-2 backward vs plain (normalized,
    BWD_TOL) at `shape` = (B, S, H, KV, D, window), causal or not, on
    `Sk` keys (None: S), two backward runs the same bits; the backward's
    errors go into `out`.  Returns (the case's name, the forward's max
    abs error)."""
    torch, fa = m["torch"], m["fa_ops"]
    B, S, H, KV, D, w = shape
    Sk = S if Sk is None else Sk
    name = str(dt).replace("torch.", "")
    q, k, v, do = (torch.randn(B, n, h, D, generator=g, device="cuda")
                   .to(dt) for n, h in ((S, H), (Sk, KV), (Sk, KV), (S, H)))
    kw = dict(causal=causal, window=w)
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    _check(torch.equal(o, fa.flash_attention_cuda(q, k, v, **kw)),
           f"flash {name} {label} S={S}: out changes with the LSE")
    o_ref, lse_ref = m["flash_fwd_ref"](q, k, v, **kw)
    what = (f"flash {name} {label}S={S} H={H} KV={KV} D={D} window={w}"
            + ("" if causal else f" non-causal Sk={Sk}"))
    fwd = _max_err(torch, o, o_ref, FWD_TOL[name][0], what)
    _max_err(torch, lse, lse_ref, 1e-4, f"{what} lse")
    del o_ref, lse_ref
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"flash_bwd {what}: two runs differ")
    _check(got[1].shape == k.shape and got[2].shape == v.shape,
           f"flash_bwd {what}: dk {tuple(got[1].shape)}, want "
           f"{tuple(k.shape)}")
    want = m["flash_bwd_ref"](q, k, v, o, lse, do, **kw)
    for grad, a, b in zip(("dq", "dk", "dv"), got, want):
        err, rel = _rel_err(torch, a, b, BWD_TOL[name],
                            f"flash_bwd {what} {grad}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["normalized_err"][f"{what} {grad}"] = rel
    return what, fwd


def _flash_window_check(m, g, dt) -> tuple:
    """The flash forward at FLASH_WINDOW_NEW (causal, window 4096 over
    S 4104, so the window binds on the last 8 rows) against
    ``flash_fwd_ref``, FWD_TOL.  Returns (the case's name, max abs
    error)."""
    torch, fa = m["torch"], m["fa_ops"]
    B, S, H, KV, D, w = FLASH_WINDOW_NEW
    name = str(dt).replace("torch.", "")
    q, k, v = (torch.randn(B, S, h, D, generator=g, device="cuda").to(dt)
               for h in (H, KV, KV))
    got = fa.flash_attention_cuda(q, k, v, window=w)
    what = f"flash {name} zamba2 long-context S={S} H={H} D={D} window={w}"
    err = _max_err(torch, got, m["flash_fwd_ref"](q, k, v, window=w)[0],
                   FWD_TOL[name][0], what)
    return what, err


def family_kernel_phase(m) -> dict:
    """The two new backward kernels against their plain versions at the
    train shapes, each run twice for identical bits: the dispatch's
    bit-exact at olmoe's and deepseek's widths (d 2048, E 64, top-8 /
    top-6), T 1 / 64 / 4096, C tight (pairs dropped), the model's
    capacity and ample, bf16 and fp32; SSD's four grads against the plain backward in fp64 at
    [1,16,256,112,64,64] and [1,1,64,112,64,64], mild and steep decay,
    max |Δ| / max |want| <= SSD_BWD_TOL, beside the plain fp32
    version's own figure; and flash (forward and FA-2 backward) at
    D 128 and D 112, as ``train_kernel_phase`` holds it at D 80, and
    at the shapes of FLASH_BWD_NEW (non-causal, Sk != S, D 64, D 128
    with 8 query heads to a kv head), with the windowed forward at
    FLASH_WINDOW_NEW; and the RMSNorm forward and backward, both forms,
    at NORM_BWD_FAMILY, as ``_norm_check`` holds them (under
    ``norms``)."""
    torch = m["torch"]
    d_ops, s_ops = m["dispatch_ops"], m["ssd_ops"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {"moe_dispatch_bwd": {"max_abs_err": 0.0, "dropped": {}},
           "ssd_intra_bwd": {"max_abs_err": 0.0, "normalized_err": {},
                             "plain_fp32_normalized_err": {}},
           "flash_attention_bwd": {"max_abs_err": 0.0,
                                   "normalized_err": {}},
           "forward": {}}
    for arch in (OLMOE, DEEPSEEK):
        cfg = m["get_config"](arch)
        E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
        for dt in (torch.bfloat16, torch.float32):
            for T in DISPATCH_BWD_TS:
                x, eidx = dispatch_inputs(torch, g, T, d, E, k, dt)
                for kind, C in (("tight", max(1, T * k // E)),
                                ("model", m["moe_capacity"](T, cfg)),
                                ("ample", T)):
                    dest = d_ops.moe_dispatch_cuda(eidx, x, E, C)[1]
                    dbuf = torch.randn(E, C, d, generator=g,
                                       device="cuda").to(dt)
                    got = d_ops.moe_dispatch_bwd_cuda(dbuf, dest, T, k)
                    again = d_ops.moe_dispatch_bwd_cuda(dbuf, dest, T, k)
                    torch.cuda.synchronize()
                    want = m["moe_dispatch_bwd_ref"](dbuf, dest, T, k)
                    what = f"moe_dispatch_bwd {arch} {dt} T={T} C={C}"
                    _check(got.dtype == want.dtype
                           and torch.equal(got, want), f"{what}: not "
                           "bit-exact with the plain version")
                    _check(torch.equal(got, again), f"{what}: two runs "
                           "differ")
                    out["moe_dispatch_bwd"]["dropped"][
                        f"{arch} {T}/{kind}"] = int((dest == E * C).sum())
                    del dest, dbuf, got, again, want
                del x, eidx
    drops = out["moe_dispatch_bwd"]["dropped"]
    _check(all(drops[f"{a} {FAMILY_SEQ}/tight"] > 0
               and drops[f"{a} {FAMILY_SEQ}/ample"] == 0
               for a in (OLMOE, DEEPSEEK)), f"dispatch drops {drops}")
    rec = out["ssd_intra_bwd"]
    for nc, Q in SSD_BWD_SHAPES:
        for rate in (0.1, 10.0):
            args = ssd_inputs(torch, g, nc, Q, rate=rate)
            dy = torch.randn(args[1].shape, generator=g, device="cuda")
            dS = torch.randn(1, nc, 112, 64, 64, generator=g, device="cuda")
            got = s_ops.ssd_intra_bwd_cuda(*args, dy, dS)
            again = s_ops.ssd_intra_bwd_cuda(*args, dy, dS)
            torch.cuda.synchronize()
            want = m["ssd_intra_bwd_ref"](
                *(t.double() for t in (*args, dy, dS)))
            plain = m["ssd_intra_bwd_ref"](*args, dy, dS)
            for name, a, b, w, p in zip(("dcum", "dxdt", "dB", "dC"), got,
                                        again, want, plain):
                what = f"ssd_intra_bwd [1,{nc},{Q},112,64,64] rate={rate} " \
                       f"{name}"
                _check(torch.equal(a, b), f"{what}: two runs differ")
                err, rel = _rel_err(torch, a.double(), w, SSD_BWD_TOL, what)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["normalized_err"][what] = rel
                rec["plain_fp32_normalized_err"][what] = float(
                    (p.double() - w).abs().max()) / float(w.abs().max())
            del args, dy, dS, got, again, want, plain
    for label, shape in FLASH_BWD_FAMILY.items():
        for dt in (torch.bfloat16, torch.float32):
            what, e = _flash_bwd_check(m, g, shape, dt,
                                       out["flash_attention_bwd"],
                                       label + " ")
            out["forward"][what] = e
    for label, (shape, causal, Sk) in FLASH_BWD_NEW.items():
        for dt in (torch.bfloat16, torch.float32):
            what, e = _flash_bwd_check(m, g, shape, dt,
                                       out["flash_attention_bwd"],
                                       label + " ", causal, Sk)
            out["forward"][what] = e
            _free(torch)
    for dt in (torch.bfloat16, torch.float32):
        what, e = _flash_window_check(m, g, dt)
        out["forward"][what] = e
    _free(torch)
    norms = out["norms"] = {
        name: {"max_abs_err": 0.0, "normalized_err": {}}
        for name in ("rmsnorm_bwd", "add_rmsnorm_bwd")}
    norms["forward"] = {}
    for dt in (torch.bfloat16, torch.float32):
        for rows, d in NORM_BWD_FAMILY:
            _norm_check(m, g, rows, d, dt, norms)
    _free(torch)
    return out


def family_reduced_phase(m) -> dict:
    """Reduced fp32 olmoe-1b-7b and deepseek-moe-16b (2 layers),
    zamba2-7b (2 groups of 3 Mamba blocks and the shared block, then a
    1-block tail), xlstm-125m (2 blocks, the pattern ("m", "s"): the
    reduced config's 4 layers of its pattern hold no sLSTM block),
    whisper-tiny (2 encoder and 2 decoder layers over 32 stub frames:
    the encoder's non-causal attention, the cross-attention's 64 queries
    on 32 keys, whose dK and dV feed the encoder) and internvl2-76b (2
    layers, 8 patch positions): one step on the card against the CPU
    (``card_vs_cpu_step``), remat full, so every checkpointed forward
    kernel runs twice (zamba2's tail and whisper's encoder once) and
    every backward kernel once."""
    out = {}
    for arch, layers in ((OLMOE, 2), (DEEPSEEK, 2), (ZAMBA, 7), (XLSTM, 2),
                         (WHISPER, 2), (INTERNVL, 2)):
        cfg = m["reduced_config"](arch).replace(num_layers=layers,
                                                dtype="float32")
        if cfg.family == "xlstm":
            cfg = cfg.replace(xlstm_pattern=("m", "s"))
        # zamba2's fp32 grads at two groups differ by up to 3.4e-5 of
        # their largest entry between the two packages on the CPU
        # (tests/test_torch_train_families.py): weights whose grad is
        # below 1e-4 of its leaf's largest are left out of the params;
        # an sLSTM block's input-gate bias has a grad of zero but for
        # rounding (the same file), held to the largest grad of any leaf
        rec = out[arch] = card_vs_cpu_step(
            m, cfg, grad_floor=1e-4 if cfg.family == "hybrid" else 0.0,
            vanishing={f"layer_{i:02d}.cell.b_i" for i, kind in enumerate(
                m["xlstm_lm"].layer_kinds(cfg)) if kind == "s"}
            if cfg.family == "xlstm" else ())
        n = rec["launches"]
        if cfg.family == "hybrid":
            groups, g, tail = layers // cfg.attn_every, cfg.attn_every, \
                layers % cfg.attn_every
            want = {"ssd_intra": 2 * groups * g + tail,
                    "ssd_intra_bwd": layers, "flash_attention": 2 * groups,
                    "flash_attention_bwd": groups}
        elif cfg.family == "xlstm":
            want = {"flash_attention": 0, "flash_attention_bwd": 0}
        elif cfg.family == "audio":
            # the encoder's layers once, each decoder layer's self- and
            # cross-attention twice
            want = {"flash_attention": cfg.encoder_layers + 4 * layers,
                    "flash_attention_bwd": cfg.encoder_layers + 2 * layers}
        else:
            moe = layers - cfg.moe.first_k_dense if cfg.is_moe else 0
            want = {"moe_dispatch": 2 * moe, "moe_dispatch_bwd": moe,
                    "flash_attention": 2 * layers,
                    "flash_attention_bwd": layers}
        _check(all(n[k] == v for k, v in want.items())
               and n["rmsnorm_bwd"] > 0 and n["add_rmsnorm_bwd"] > 0,
               f"{arch} reduced fp32 step launches {n}, want {want}")
    return out


def family_train_path(m, arch: str, layers: int) -> dict:
    """Full-width `arch` with its depth cut to `layers`, bf16, from seed
    0: ``training.loop.make_train_step`` on ``data.pipeline.Loader``
    batches (seq FAMILY_SEQ, or the arch's FAMILY_SEQ_OF, batch
    TRAIN_BATCH in microbatches of TRAIN_MICRO, remat full, lr
    TRAIN_LR, warm-up 1 step as the train CLI sets it), TRAIN_STEPS steps; every launch count zeroed just
    before the steps and read just after.  Each step's loss and grad
    norm must be finite and > 0, its peak under 80 GB.  One more step
    runs under the profiler (``_profiled_step``), each sLSTM block in a
    range of its own (SLSTM_RANGE)."""
    torch, tl = m["torch"], m["train_loop"]
    seq = FAMILY_SEQ_OF.get(arch, FAMILY_SEQ)
    full = m["get_config"](arch).num_layers
    cfg = m["get_config"](arch).replace(num_layers=layers)
    depth = (f"{layers} of {full} layers" if layers == full
             else f"{layers} of {full} layers (depth cut)")
    tc = m["TrainConfig"](learning_rate=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=1, microbatch=TRAIN_MICRO,
                          remat="full")
    _free(torch)
    t0 = time.perf_counter()
    state, step, loader = _train_setup(m, cfg, tc, "cuda", seq=seq,
                                       batch=TRAIN_BATCH)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"[train] {arch} full width, {depth}, seq {seq}: "
          f"{n_params / 1e9:.3f}B "
          f"params bf16, state in {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    steps = []
    _zero_counts(m)
    for i in range(TRAIN_STEPS):
        batch = next(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, met = step(state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        rec = {"step": i + 1, "loss": loss, "grad_norm": gnorm,
               "step_ms": 1e3 * dt,
               "tokens_per_s": seq * TRAIN_BATCH / dt,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(rec)
        print(f"[train] {arch} ({depth}) step {i + 1}: loss {loss:.4f} "
              f"gnorm {gnorm:.3f} {rec['step_ms']:.1f} ms "
              f"{rec['tokens_per_s']:.0f} tok/s peak {rec['peak_gb']:.2f} "
              "GB", flush=True)
    counts = _counts(m)
    _check(all(math.isfinite(h["loss"]) and h["loss"] > 0
               and math.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
               and h["peak_gb"] < 80 for h in steps),
           f"{arch} ({depth}) steps: {steps}")
    names = ["rmsnorm", "add_rmsnorm", "rmsnorm_bwd", "add_rmsnorm_bwd"]
    if cfg.family != "xlstm":           # attention-free
        names += ["flash_attention", "flash_attention_bwd"]
    if cfg.is_moe:
        names += ["moe_dispatch", "moe_dispatch_bwd"]
    if cfg.family == "hybrid":
        names += ["ssd_intra", "ssd_intra_bwd"]
    for name in names:
        _check(counts[name] > 0, f"no {name} launch on the {arch} train "
               "path")
    routes = dict(m["fa_ops"].launches_by_route)
    _check(routes == {"wgmma": counts["flash_attention"], "fma": 0},
           f"bf16 training ran flash on routes {routes}")
    # one more step under the profiler, after the counts are read; an
    # xlstm step's sLSTM blocks in a range of their own
    from torch.profiler import record_function
    xl, slstm = m["xlstm"], m["xlstm"].slstm_forward

    def ranged(*args, **kw):
        with record_function(SLSTM_RANGE):
            return slstm(*args, **kw)

    xl.slstm_forward = ranged
    try:
        state, prof = _profiled_step(m, step, state, next(loader))
    finally:
        xl.slstm_forward = slstm
    _check((prof["slstm"]["ranges"] > 0) == (cfg.family == "xlstm"),
           f"{arch} profiled step: sLSTM ranges {prof['slstm']}")
    print(f"[train] {arch} ({depth}) profiled step: "
          f"{json.dumps(prof)}", flush=True)
    out = {"arch": arch, "depth": depth, "layers": layers,
           "params": n_params, "seq": seq, "batch": TRAIN_BATCH,
           "microbatch": TRAIN_MICRO, "steps": steps, "launches": counts,
           "flash_launches_by_route": routes, "profile": prof}
    if cfg.is_moe:
        # and one with the slots that reach the dispatch backward kept,
        # so that it is timed on this path's own routing
        d_ops, real, routing = m["dispatch_ops"], \
            m["dispatch_ops"].moe_dispatch_bwd_cuda, []

        def recording(dbuf, dest_tk, T, k):
            routing.append((dest_tk.clone(), dbuf.shape[0] * dbuf.shape[1]))
            return real(dbuf, dest_tk, T, k)

        d_ops.moe_dispatch_bwd_cuda = recording
        try:
            state, met = step(state, next(loader))
            torch.cuda.synchronize()
        finally:
            d_ops.moe_dispatch_bwd_cuda = real
        out["dropped_share"] = [float((dest == ec).sum()) / dest.numel()
                                for dest, ec in routing]
        out["routing"] = routing
        print(f"[train] {arch} ({depth}) dispatch backward: dropped share "
              f"of pairs by call {out['dropped_share']}", flush=True)
    del state, step, loader, batch, met
    _free(torch)
    return out


def _launch_ms(torch, fn, prefix: str, reps: int = 10) -> dict:
    """Device ms per launch of each CUDA function of `fn` whose name
    starts with `prefix` (by name and template arguments), from
    ``torch.profiler`` over `reps` calls (per recorded launch: the
    profiler may drop some of a window's launches, so this is no count
    of them; ``_launches_per_call`` counts them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(prefix + r"\w*(<[^>]*>)?", e.key)
        if name and e.self_device_time_total > 0:
            out[name.group(0)] = e.self_device_time_total / 1e3 / e.count
    return out


def _ssd_bwd_work(B, nc, Q, H, P, N) -> tuple:
    """(bytes, flops) the SSD backward must move and do: its six inputs
    read and four outputs written once (fp32); the products over the
    lower triangle (dM = dy xdtᵀ and Mᵀ dy per head, C Bᵀ, dCB B and
    dCBᵀ C once per chunk) and the dS terms (B dS, xdt dSᵀ per head)."""
    tri = Q * (Q + 1) // 2
    nbytes = 4 * B * nc * (2 * Q * H + 3 * Q * H * P + 4 * Q * N + H * N * P)
    flops = 2 * B * nc * (2 * tri * P * H + 3 * tri * N + 2 * Q * N * P * H)
    return nbytes, flops


def _dispatch_bwd_times(m, dest, dbuf, T, k) -> dict:
    """The dispatch backward on slot map `dest`: kernel, plain version
    and the library call (``torch.index_add`` of the kept slots' rows,
    gathered beforehand, onto a zeroed dx; timed here only), with the
    bound of the kept rows read, dx written and the slot ids read."""
    torch, d_ops = m["torch"], m["dispatch_ops"]
    E, C, d = dbuf.shape
    keep = dest < E * C
    kept = int(keep.sum())
    tok = (torch.arange(T * k, device="cuda") // k)[keep]
    rows = dbuf.reshape(E * C, d)[dest[keep].long()]
    zeros = torch.zeros(T, d, dtype=dbuf.dtype, device="cuda")
    return {"shape": [T, k, d, E, C], "dtype": str(dbuf.dtype)[6:],
            "kept_pairs": kept, "dropped_share": 1 - kept / (T * k),
            **_times(torch,
                     lambda: d_ops.moe_dispatch_bwd_cuda(dbuf, dest, T, k),
                     lambda: m["moe_dispatch_bwd_ref"](dbuf, dest, T, k),
                     lambda: torch.index_add(zeros, 0, tok, rows)),
            **_bound(dbuf.element_size() * (kept + T) * d + 4 * T * k,
                     kept * d, FP32_FLOPS)}


def family_timing(m, routing) -> dict:
    """The two new backward kernels at the train shapes, their plain
    versions and, for the dispatch, the library call computing the same
    function; device ms from CUDA-graph replays.  The dispatch at
    olmoe's step (T 4096, top-8, d 2048, E 64, C 640 = ``moe_capacity``),
    bf16, on the slot map of the ``train_moe`` call with the median
    dropped share among `routing` (the slot maps that path's dispatch
    backward got), and on the skewed router of ``dispatch_inputs``; SSD
    at zamba2's [1,16,256,112,64,64], fp32.  Flash's backward at D 128
    and D 112 against SDPA's causal backward on the same pairs (CUDA
    events)."""
    torch, F = m["torch"], m["F"]
    d_ops, s_ops, fa = m["dispatch_ops"], m["ssd_ops"], m["fa_ops"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out = {}
    cfg = m["get_config"](OLMOE)
    E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    T = FAMILY_SEQ
    C = m["moe_capacity"](T, cfg)
    dbuf = torch.randn(E, C, d, generator=g, device="cuda").to(torch.bfloat16)
    routing = sorted((dest for dest, ec in routing
                      if ec == E * C and dest.numel() == T * k),
                     key=lambda dest: int((dest == E * C).sum()))
    _check(len(routing) > 0, f"no train_moe slot map of T {T}, E*C {E * C}")
    out["moe_dispatch_bwd"] = _dispatch_bwd_times(
        m, routing[len(routing) // 2], dbuf, T, k)
    x, eidx = dispatch_inputs(torch, g, T, d, E, k, torch.bfloat16)
    out["moe_dispatch_bwd"]["skewed"] = _dispatch_bwd_times(
        m, d_ops.moe_dispatch_cuda(eidx, x, E, C)[1], dbuf, T, k)
    del x, eidx, dbuf, routing
    nc, Q = SSD_BWD_SHAPES[0]
    args = ssd_inputs(torch, g, nc, Q)
    dy = torch.randn(args[1].shape, generator=g, device="cuda")
    dS = torch.randn(1, nc, 112, 64, 64, generator=g, device="cuda")
    kern = lambda: s_ops.ssd_intra_bwd_cuda(*args, dy, dS)  # noqa: E731
    plain = lambda: m["ssd_intra_bwd_ref"](*args, dy, dS)  # noqa: E731
    nbytes, flops = _ssd_bwd_work(1, nc, Q, 112, 64, 64)
    out["ssd_intra_bwd"] = {
        "shape": [1, nc, Q, 112, 64, 64], "dtype": "float32",
        "ms": _device_ms(torch, kern, reps=5, inner=4),
        "call_ms": _time_ms(torch, kern, reps=5, inner=4),
        "plain_ms": _device_ms(torch, plain, reps=3, inner=1),
        "library_ms": None,
        "kernel_ms": _launch_ms(torch, kern, r"ssd_bwd_"),
        # the products run on the tensor cores in 3xTF32 and count at
        # that rate; beside it the same work as fp32 FMA
        "fp32_fma_bound_ms": _bound(nbytes, flops, FP32_FLOPS)["bound_ms"],
        **_bound(nbytes, flops, FP32_FLOPS, tc_flops=flops)}
    del args, dy, dS
    _free(torch)
    flash = {}
    for label, (B, S, H, KV, D, W) in FLASH_BWD_FAMILY.items():
        q, k_, v, do = flash_bwd_inputs(torch, g, B, S, H, KV, D,
                                        torch.bfloat16)
        o, lse = fa.flash_attention_cuda(q, k_, v, window=W, with_lse=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k_, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        pairs = _pairs(S, W)
        flash[label] = {
            "shape": [B, S, H, KV, D], "dtype": "bfloat16", "pairs": pairs,
            "ms": _time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k_, v, o, lse, do, window=W), reps=5, inner=4),
            "library_ms": _time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), reps=5,
                inner=4),
            **_bound(2 * (4 * S * H * D + 4 * S * KV * D) + 4 * B * H * S,
                     10 * D * pairs * H, BF16_FLOPS)}
        del q, k_, v, do, o, lse, qt, kt, vt, lib_out, dot
    out["flash_attention_bwd"] = flash
    _free(torch)
    return out


def new_flash_timing(m) -> dict:
    """The new flash forms in bf16 against SDPA computing the
    same function: at each FLASH_BWD_NEW shape but the odd one, the
    FA-2 backward (``ms``; CUDA events around eager calls, as
    ``family_timing``) against SDPA's backward (``library_ms``; causal
    or not, ``enable_gqa`` where heads are grouped) and the plain
    backward (``plain_ms``), and the forward (``fwd_ms``, CUDA-graph
    replays) against SDPA's; the windowed forward at FLASH_WINDOW_NEW
    against SDPA with the window as a boolean mask and the plain
    forward.  Bounds: 10 D (backward) and 4 D (forward) flops per
    unmasked pair and head at the bf16 peak, or the bytes (inputs read
    once, outputs written once), whichever is longer."""
    torch, F, fa = m["torch"], m["F"], m["fa_ops"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    out = {}
    for label, ((B, S, H, KV, D, W), causal, Sk) in FLASH_BWD_NEW.items():
        if label == "odd":
            continue
        Sk = S if Sk is None else Sk
        kw = dict(causal=causal, window=W)
        q, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, Sk, KV, D, generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = dict(is_causal=causal, enable_gqa=H != KV)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
        dot = do.transpose(1, 2)
        pairs = _pairs(S, W) if causal else S * Sk
        out[label] = {
            "shape": [B, S, Sk, H, KV, D], "causal": causal,
            "dtype": "bfloat16", "pairs": pairs,
            "ms": _time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, **kw), reps=5, inner=4),
            "plain_ms": _time_ms(torch, lambda: m["flash_bwd_ref"](
                q, k, v, o, lse, do, **kw), reps=2, inner=1),
            "library_ms": _time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), reps=5,
                inner=4),
            **_bound(2 * (4 * S * H * D + 4 * Sk * KV * D) + 4 * B * H * S,
                     10 * D * pairs * H, BF16_FLOPS),
            "fwd_ms": _device_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, **kw), reps=10, inner=4),
            "fwd_library_ms": _device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt.detach(), kt.detach(), vt.detach(), **sdpa),
                reps=10, inner=4),
            "fwd_bound_ms": _bound(2 * (2 * S * H * D + 2 * Sk * KV * D),
                                   4 * D * pairs * H,
                                   BF16_FLOPS)["bound_ms"]}
        del q, k, v, do, o, lse, qt, kt, vt, lib_out, dot
        _free(torch)
    B, S, H, KV, D, W = FLASH_WINDOW_NEW
    q, k, v = (torch.randn(B, S, h, D, generator=g, device="cuda")
               .to(torch.bfloat16) for h in (H, KV, KV))
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = _pairs(S, W)
    out["zamba2 long-context forward"] = {
        "shape": [B, S, H, KV, D], "window": W, "dtype": "bfloat16",
        "pairs": pairs,
        **_times(torch, lambda: fa.flash_attention_cuda(q, k, v, window=W),
                 lambda: m["attention_ref"](q, k, v, window=W),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                        attn_mask=mask)),
        **_bound(2 * (2 * S * H * D + 2 * S * KV * D), 4 * D * pairs * H,
                 BF16_FLOPS)}
    del q, k, v, qt, kt, vt, mask
    _free(torch)
    return out


def train_phase(m) -> dict:
    out = {"kernels": train_kernel_phase(m)}
    print(f"[train] backward kernels vs plain: "
          f"{json.dumps(out['kernels'])}", flush=True)
    out["reduced"] = train_reduced_phase(m)
    print(f"[train] reduced danube: {json.dumps(out['reduced'])}",
          flush=True)
    out["train"] = train_cli_phase(m)
    for s in out["train"]["steps"]:
        print(f"[train] full-width {DANUBE} step {s['step']}: loss "
              f"{s['loss']:.4f} gnorm {s['grad_norm']:.3f} "
              f"{s['step_ms']:.1f} ms {s['tokens_per_s']:.0f} tok/s "
              f"peak {s['peak_gb']:.2f} GB", flush=True)
    out["profile"] = train_profile(m)
    out["timings"] = train_timing(m)
    out["family_kernels"] = family_kernel_phase(m)
    print(f"[train] dispatch and SSD backward kernels, flash at the "
          f"families' forms and the norms at their widths vs plain: "
          f"{json.dumps(out['family_kernels'])}", flush=True)
    out["family_reduced"] = family_reduced_phase(m)
    print(f"[train] reduced olmoe, deepseek, zamba2, xlstm, whisper, "
          f"internvl card vs cpu: "
          f"{json.dumps(out['family_reduced'])}", flush=True)
    out["train_moe"] = family_train_path(m, *MOE_TRAIN)
    out["train_hybrid"] = family_train_path(m, *HYBRID_TRAIN)
    out["family_timings"] = family_timing(
        m, out["train_moe"].pop("routing"))
    print(f"[train] family timings: {json.dumps(out['family_timings'])}",
          flush=True)
    for key, (arch, layers) in NEW_TRAIN.items():
        out[key] = family_train_path(m, arch, layers)
    out["new_flash_timings"] = new_flash_timing(m)
    print(f"[train] new flash forms vs SDPA: "
          f"{json.dumps(out['new_flash_timings'])}", flush=True)
    return out


# ---------------------------------------------------------------------------
# the norm of rows split over ranks (zamba2's gated norm, partitioned)
# ---------------------------------------------------------------------------

# zamba2-7b's gated output in its train and prefill check cells, [rows,
# d_inner] bf16, and the model ranks that split d_inner on its meshes
NORM_SPLIT_SHAPE = (4096, 7168)
NORM_SPLIT_RANKS = 16
NORM_SPLIT_KERNELS = ("rmsnorm_row_stat", "rmsnorm_row_fwd",
                      "rmsnorm_row_bwd")


def _norm_split(m, fns, x, sc, dy, blocks: int) -> tuple:
    """The split-row norm over `blocks` column blocks of x [rows, d], the
    blocks' statistics summed between the passes (each rank's view of
    the all-reduce): (ss, dot, y, dx, dscale, the blocks' (stat, fwd,
    bwd) outputs).  `fns`: (stat, fwd, bwd), the kernels or their plain
    versions."""
    stat, fwd, bwd = fns
    d = x.shape[-1]
    xs, ss_, dys = ([c.contiguous() for c in t.chunk(blocks, dim=-1)]
                    for t in (x, sc, dy))
    stats = [stat(t) for t in xs]
    ss = sum(stats)
    ys = [fwd(t, ss, s, d, 1e-5) for t, s in zip(xs, ss_)]
    dots = [stat(t, o, s) for t, o, s in zip(xs, dys, ss_)]
    dot = sum(dots)
    parts = [bwd(t, o, s, ss, dot, d, 1e-5) for t, o, s in zip(xs, dys, ss_)]
    torch = m["torch"]
    return (ss, dot, torch.cat(ys, dim=-1),
            torch.cat([p[0] for p in parts], dim=-1),
            torch.cat([p[1] for p in parts]),
            {"stat": stats + dots, "fwd": ys, "bwd": parts})


def norm_split_phase(m) -> dict:
    """The kernels of the norm of rows split over ranks (``csrc/rmsnorm.cu``
    ``rmsnorm_row_*``, ``rms_ops.rmsnorm_split``) at zamba2's gated
    output NORM_SPLIT_SHAPE in bf16, twice: split into NORM_SPLIT_RANKS
    column blocks of 448 as its model ranks hold it ("rank_block"), and
    in one block, the whole row a rank holds in the check cells at 1 x 1
    ("whole_row": the kernel builds the main path launches).  In each,
    the blocks' statistics are summed between the passes; each kernel
    is held against its plain version on the same inputs (the
    statistics 1e-5 normalized; FWD_TOL; the backward BWD_TOL); the
    assembled forward and backward against the whole-row kernels and
    the whole-row plain norm; two runs the same bits.  In one block the
    outputs must be the whole-row kernels' bits.  Timed (device ms,
    CUDA graphs) on one rank's block [4096, 448] and on the whole row,
    beside the whole-row kernels at the same rows and the plain
    versions; bounds by bytes (each input read once, each output
    written once) or fp32 operations."""
    torch, rms = m["torch"], m["rms_ops"]
    from repro_torch.kernels.rmsnorm import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, d = NORM_SPLIT_SHAPE
    dt = torch.bfloat16
    x, dy = (torch.randn(rows, d, generator=g, device="cuda").to(dt)
             for _ in range(2))
    sc = (torch.rand(d, generator=g, device="cuda") + 0.5).to(dt)
    kern = (rms.row_stat_cuda, rms.row_fwd_cuda, rms.row_bwd_cuda)
    ftol, btol = FWD_TOL["bfloat16"][1], BWD_TOL["bfloat16"]
    whole_y = rms.rmsnorm_cuda(x, sc)
    whole_dx, whole_ds = rms.rmsnorm_bwd_cuda(x, None, dy, sc)
    plain_y = m["rmsnorm_ref"](x, sc)
    plain_dx, plain_ds = m["rmsnorm_bwd_ref"](x, sc, dy)
    err, vs_whole = {}, {}
    for label, n in (("rank_block", NORM_SPLIT_RANKS), ("whole_row", 1)):
        what = f"bf16 [{rows},{d}] in {n} block(s)"
        got = _norm_split(m, kern, x, sc, dy, n)
        again = _norm_split(m, kern, x, sc, dy, n)
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])),
               f"split norm {what}: two runs differ")
        blocks = got[5]
        xs, ss_, dys = ([c.contiguous() for c in t.chunk(n, -1)]
                        for t in (x, sc, dy))
        e = {}
        # each kernel on its own inputs against its plain version
        want_stats = ([ref.row_stat_ref(t) for t in xs]
                      + [ref.row_stat_ref(t, o, s)
                         for t, o, s in zip(xs, dys, ss_)])
        e["rmsnorm_row_stat"] = max(
            _rel_err(torch, a, b, 1e-5, f"rmsnorm_row_stat {what}")[0]
            for a, b in zip(blocks["stat"], want_stats))
        ss, dot = got[0], got[1]
        e["rmsnorm_row_fwd"] = max(
            _max_err(torch, a, ref.row_fwd_ref(t, ss, s, d), ftol,
                     f"rmsnorm_row_fwd {what}")
            for a, t, s in zip(blocks["fwd"], xs, ss_))
        bwd_err = 0.0
        for (a, b), t, o, s in zip(blocks["bwd"], xs, dys, ss_):
            wa, wb = ref.row_bwd_ref(t, o, s, ss, dot, d)
            bwd_err = max(
                bwd_err,
                _rel_err(torch, a, wa, btol, f"row_bwd {what} dx")[0],
                _rel_err(torch, b, wb, btol, f"row_bwd {what} dscale")[0])
        e["rmsnorm_row_bwd"] = bwd_err
        err[label] = e
        # the assembled norm against the whole-row kernels and plain norm
        y, dx, dscale = got[2:5]
        vs_whole[label] = {
            "y": _max_err(torch, y, whole_y, ftol, f"split norm {what} y"),
            "y_plain": _max_err(torch, y, plain_y, ftol,
                                f"split norm {what} y vs plain"),
            "dx": _rel_err(torch, dx, whole_dx, btol,
                           f"split {what} dx")[1],
            "dscale": _rel_err(torch, dscale, whole_ds, btol,
                               f"split {what} dscale")[1],
            "dx_plain": _rel_err(torch, dx, plain_dx, btol,
                                 f"split {what} dx vs plain")[1],
            "dscale_plain": _rel_err(torch, dscale, plain_ds, btol,
                                     f"split {what} dscale vs plain")[1]}
        if n == 1:
            one_block_bits = {"y": torch.equal(y, whole_y),
                              "dx": torch.equal(dx, whole_dx),
                              "dscale": torch.equal(dscale, whole_ds)}
            _check(all(one_block_bits.values()),
                   f"split norm {what}: not the whole-row kernels' bits "
                   f"{one_block_bits}")
        del got, again, blocks
    # device ms: one rank's block and the whole row (the 1 x 1 path)
    timings = {}
    for label, n in (("rank_block", NORM_SPLIT_RANKS), ("whole_row", 1)):
        xb, sb, db = (t.chunk(n, dim=-1)[0].contiguous()
                      for t in (x, sc, dy))
        db_ = xb.shape[-1]
        ssb = ref.row_stat_ref(xb)
        dotb = ref.row_stat_ref(xb, db, sb)
        nb = xb.numel() * xb.element_size()
        sb_b = sb.numel() * sb.element_size()
        calls = {
            "rmsnorm_row_stat": (
                lambda: rms.row_stat_cuda(xb),
                lambda: ref.row_stat_ref(xb),
                nb + 4 * rows, 2 * xb.numel()),
            "rmsnorm_row_fwd": (
                lambda: rms.row_fwd_cuda(xb, ssb, sb, d, 1e-5),
                lambda: ref.row_fwd_ref(xb, ssb, sb, d),
                2 * nb + sb_b + 4 * rows, 2 * xb.numel()),
            "rmsnorm_row_bwd": (
                lambda: rms.row_bwd_cuda(xb, db, sb, ssb, dotb, d, 1e-5),
                lambda: ref.row_bwd_ref(xb, db, sb, ssb, dotb, d),
                3 * nb + 2 * sb_b + 8 * rows, 8 * xb.numel()),
            "rmsnorm_row_stat (backward's)": (
                lambda: rms.row_stat_cuda(xb, db, sb),
                lambda: ref.row_stat_ref(xb, db, sb),
                2 * nb + sb_b + 4 * rows, 3 * xb.numel())}
        rec = {}
        for name, (kfn, pfn, nbytes, flops) in calls.items():
            rec[name] = {"shape": [rows, db_], **_times(torch, kfn, pfn,
                                                         None),
                         **_bound(nbytes, flops, FP32_FLOPS)}
        rec["whole_row_kernels"] = {
            "shape": [rows, db_],
            "rmsnorm_ms": _device_ms(torch,
                                     lambda: rms.rmsnorm_cuda(xb, sb)),
            "rmsnorm_bwd_ms": _device_ms(
                torch, lambda: rms.rmsnorm_bwd_cuda(xb, None, db, sb))}
        timings[label] = rec
    return {"shape": [rows, d], "ranks": NORM_SPLIT_RANKS,
            "max_abs_err": err, "vs_whole": vs_whole,
            "one_block_bit_equal": one_block_bits, "timings": timings}


# ---------------------------------------------------------------------------
# the distributed layer on a world of one rank over NCCL
# ---------------------------------------------------------------------------

MESH_STEPS = 2
A2A_SHAPE = (2, 4096)            # olmoe-1b-7b's train batch: x [2, 4096, 2048]
# bf16 outputs of two orders of the same fp32 sums: one bf16 ulp (2^-8)
# of the largest entry, normalized as BWD_TOL is; aux is fp32
A2A_TOL = {"y": 1e-2, "dx": 1e-2, "aux": 1e-6}


def mesh_phase(m) -> dict:
    """The distributed layer on the card, in a world of one rank over
    NCCL (``launch.mesh.init_world``), destroyed at the end:

    (a) full-width h2o-danube-1.8b through ``launch.train.main`` with
        ``train_cli_phase``'s settings for MESH_STEPS steps, without and
        with ``--mesh``: every step's loss and grad norm bit-equal, and
        the data-parallel step's NCCL all-reduces counted (> 0);
    (b) one olmoe-1b-7b MoE layer at full width (d 2048, 64 experts, top
        8; capacity raised to C = T so nothing drops) on x [2, 4096,
        2048] bf16: ``moe_a2a.moe_forward_a2a`` at ep 1 against the sort
        path (``moe_forward`` with no mesh): y, aux and the grad of x of
        sum(y * g) + aux within A2A_TOL (equal bits expected), the
        dispatch kernel and its backward launched on the a2a path
        (``mesh_a2a``), each form's forward in device ms (the sum of its
        kernels under the profiler: NCCL calls are not captured in a
        graph here) and the dispatch kernel at this shape, bit-exact
        with its plain version and timed as ``timing_phase`` times it;
    (c) ``compressed_psum``, ``ring_all_gather``, ``barrier`` (CUDA
        tensors, identities at one rank) and ``grid_spawn`` (the grid
        covered exactly)."""
    torch = m["torch"]
    dist = torch.distributed
    mesh_mod, shd = m["mesh_mod"], m["shd"]
    out = {}
    # (a) danube, plain and --mesh (which starts and ends its own world)
    argv = ["--arch", DANUBE, "--device", "cuda", "--steps",
            str(MESH_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--microbatch", str(TRAIN_MICRO), "--lr",
            str(TRAIN_LR), "--log-every", "1"]
    runs = {}
    for form in ("plain", "mesh"):
        hist = []
        m["train_loop"].grad_all_reduces = 0
        t0 = time.perf_counter()
        _check(m["train_cli"].main(
            argv + (["--mesh"] if form == "mesh" else []),
            history=hist) == 0, f"train CLI ({form}) failed")
        runs[form] = {"wall_s": time.perf_counter() - t0,
                      "all_reduces": m["train_loop"].grad_all_reduces,
                      "steps": [{k: h[k] for k in (
                          "step", "loss", "grad_norm", "step_s")}
                          for h in hist]}
        _free(torch)
    same = [(a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
            for a, b in zip(runs["plain"]["steps"],
                            runs["mesh"]["steps"])]
    _check(len(same) == MESH_STEPS and all(same),
           f"--mesh danube differs from the plain CLI: {runs}")
    _check(runs["mesh"]["all_reduces"] > 0
           and runs["plain"]["all_reduces"] == 0,
           f"NCCL all-reduces: {runs['mesh']['all_reduces']} (mesh), "
           f"{runs['plain']['all_reduces']} (plain)")
    out["danube"] = runs
    _check(not dist.is_initialized(), "--mesh left its process group")

    _, started = mesh_mod.init_world("cuda")
    _check(started and dist.get_backend() == "nccl"
           and dist.get_world_size() == 1,
           f"mesh phase: backend {dist.get_backend()}, world "
           f"{dist.get_world_size()}")
    try:
        # (b) one olmoe MoE layer: a2a at ep 1 against the sort path
        cfg = m["get_config"](OLMOE)
        E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=E / k))          # C = T: no drops
        g = torch.Generator(device="cuda").manual_seed(SEED)
        ff = cfg.moe.d_ff

        def w(*shape, fan_in, dt=torch.bfloat16):
            return (torch.randn(shape, generator=g, device="cuda")
                    / fan_in ** 0.5).to(dt).requires_grad_()
        p = {"router": w(d, E, fan_in=d, dt=torch.float32),
             "w_gate": w(E, d, ff, fan_in=d), "w_up": w(E, d, ff, fan_in=d),
             "w_down": w(E, ff, d, fan_in=ff)}
        B, S = A2A_SHAPE
        x0 = torch.randn(B, S, d, generator=g, device="cuda").to(
            torch.bfloat16)
        gy = torch.randn(B, S, d, generator=g, device="cuda")
        mesh = mesh_mod.make_test_mesh(1, 1)
        rules = shd.train_rules(mesh)

        def sort_fwd(x):
            return m["moe_forward"](p, x, cfg)

        def a2a_fwd(x):
            with shd.axis_rules(mesh, rules):
                return m["moe_a2a"].moe_forward_a2a(p, x, cfg)

        res = {}
        for form, fwd in (("sort", sort_fwd), ("a2a", a2a_fwd)):
            x = x0.clone().requires_grad_()
            _zero_counts(m)
            y, aux = fwd(x)
            ((y.float() * gy).sum() + aux).backward()
            torch.cuda.synchronize()
            res[form] = {"y": y.detach(), "aux": aux.detach(),
                         "dx": x.grad, "launches": _counts(m),
                         "flash_launches_by_route": dict(
                             m["fa_ops"].launches_by_route)}
        errs = {}
        for key in ("y", "dx"):
            errs[key] = _rel_err(torch, res["a2a"][key], res["sort"][key],
                                 A2A_TOL[key], f"a2a vs sort {key}")[1]
        aux_err = abs(float(res["a2a"]["aux"]) - float(res["sort"]["aux"]))
        _check(aux_err <= A2A_TOL["aux"] * abs(float(res["sort"]["aux"])),
               f"a2a vs sort aux: {aux_err}")
        counts = res["a2a"]["launches"]
        _check(counts["moe_dispatch"] > 0 and counts["moe_dispatch_bwd"] > 0,
               f"a2a path launches: {counts}")
        with torch.no_grad():
            ms = {form: _profiled_ms(torch, lambda f=fwd: f(x0))
                  for form, fwd in (("sort", sort_fwd), ("a2a", a2a_fwd),
                                    ("sort#2", sort_fwd), ("a2a#2", a2a_fwd))}
            # the dispatch kernel at this shape, as timing_phase times it
            T, C = B * S, m["moe_capacity"](B * S, cfg)
            xf = x0.reshape(T, d)
            eidx = m["moe_mod"].route(p["router"], xf, k)[2]
            want = m["moe_dispatch_ref"](eidx, xf, E, C)
            got = m["dispatch_ops"].moe_dispatch_cuda(eidx, xf, E, C)
            _check(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"moe_dispatch at {[T, k, d, E, C]}: not the plain "
                   f"version's buffer, slots and counts")
            _, dest_tk, cnt = want
            del got
            slot = torch.full((E * C + 1,), T, dtype=torch.long,
                              device="cuda")
            slot[dest_tk.long()] = torch.arange(T * k, device="cuda") // k
            idx = slot[:E * C].contiguous()
            xz = torch.cat([xf, torch.zeros(1, d, dtype=xf.dtype,
                                            device="cuda")])
            filled = int(torch.clamp(cnt, max=C).sum())

            def kernel():
                return m["dispatch_ops"].moe_dispatch_cuda(eidx, xf, E, C)

            def library():
                return torch.index_select(xz, 0, idx)
            # each call writes a 2.1 GB buffer: 4 calls a graph, not 20
            dispatch_t = {
                "shape": [T, k, d, E, C], "dtype": "bfloat16",
                "filled": filled,
                "ms": _device_ms(torch, kernel, reps=10, inner=4),
                "call_ms": _time_ms(torch, kernel, reps=10, inner=4),
                "plain_ms": _profiled_ms(torch, lambda: m["moe_dispatch_ref"](
                    eidx, xf, E, C), reps=5),
                "library_ms": _device_ms(torch, library, reps=10, inner=4),
                **_bound(8 * T * k + 2 * d * (filled + E * C) + 4 * T * k
                         + 4 * E, 0, BF16_FLOPS)}
            del slot, idx, xz
        out["a2a"] = {
            "shape": [B, S, d], "experts": E, "top_k": k,
            "capacity": m["moe_capacity"](B * S, cfg),
            "normalized_err": errs, "aux_abs_err": aux_err,
            "bit_equal": {key: bool(torch.equal(res["a2a"][key],
                                                res["sort"][key]))
                          for key in ("y", "aux", "dx")},
            "forward_device_ms": ms, "dispatch_timing": dispatch_t,
            "launches": counts,
            "flash_launches_by_route": res["a2a"]["flash_launches_by_route"]}
        del res, p, x0, gy
        _free(torch)

        # (c) the collectives, barrier and grid_spawn on CUDA tensors
        xc = torch.randn(4, 64, generator=g, device="cuda")
        got = {
            "compressed_psum": m["compression"].compressed_psum(
                xc, "data", mesh=mesh),
            "ring_all_gather": m["collectives"].ring_all_gather(
                xc, "model", mesh=mesh),
            "barrier": m["combinators"].barrier(xc, "data", mesh=mesh)}
        for name, t in got.items():
            _check(t.is_cuda and torch.equal(t, xc),
                   f"{name} is not the identity at one rank")
        N = 1 << 20
        parts = m["spawn"].grid_spawn(
            lambda c, ids, v: c + torch.where(v, ids + 1, 0).sum(), N,
            mesh=mesh, items_per_step=1 << 16,
            init=torch.zeros((), dtype=torch.int64, device="cuda"))()
        _check(parts.is_cuda and tuple(parts.shape) == (1,)
               and int(parts.sum()) == N * (N + 1) // 2,
               f"grid_spawn over {N} ids: {parts}")
        out["collectives"] = {"identities": sorted(got),
                              "grid_spawn_items": N}
    finally:
        dist.destroy_process_group()
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
DRYRUN_TIMEOUT = 900    # seconds for the whole dry run (its processes)
DRYRUN_RUNS = 3         # timed steps of a check cell
# the dry run's cells that fit one H100, at full width (and depth, but
# where cut as the family's training is): name: (arch, kind, seq,
# batch, microbatch of a train cell, layers or None for all, int8
# decode caches)
DRYRUN_CHECKS = {
    "phi3_prefill": (PHI3, "prefill", 4096, 1, None, None, False),
    "phi3_decode": (PHI3, "decode", 4096, 16, None, None, False),
    "danube_train": (DANUBE, "train", 4096, 2, 1, None, False),
    "olmoe_decode": (OLMOE, "decode", 4096, 16, None, None, False),
    "olmoe_train": (OLMOE, "train", 4096, 2, 1, MOE_TRAIN[1], False),
    "deepseek_prefill": (DEEPSEEK, "prefill", 4096, 1, None, None, False),
    "zamba2_prefill": (ZAMBA, "prefill", 4096, 1, None, None, False),
    "zamba2_decode": (ZAMBA, "decode", 4096, 16, None, None, False),
    "zamba2_train": (ZAMBA, "train", 4096, 2, 1, HYBRID_TRAIN[1], False),
    "phi3_decode_q8": (PHI3, "decode", 4096, 16, None, None, True),
    "whisper_train": (WHISPER, "train", 4096, 2, 1, None, False),
    "whisper_prefill": (WHISPER, "prefill", 4096, 1, None, None, False),
    "whisper_decode": (WHISPER, "decode", 4096, 16, None, None, False),
    # 320 tokens: five mLSTM chunks, past the walk's fit lengths, so the
    # CUDA and meta walks both take the fit; the caches are O(1) in the
    # decode's length
    "xlstm_train": (XLSTM, "train", 320, 2, 1, None, False),
    "xlstm_prefill": (XLSTM, "prefill", 1024, 1, None, None, False),
    "xlstm_decode": (XLSTM, "decode", 4096, 16, None, None, False),
}
VS_WHOLE_TOL = 2e-2     # bf16: max |diff| / max |whole|, if not bit-equal


def _dryrun_all(m) -> dict:
    """(a) ``python -m repro_torch.launch.dryrun --all --mesh both`` in
    its own processes (every cell on meta, nothing on the card, every
    cell partitioned on fake worlds of 256 and 512 ranks) into a
    scratch folder under ``build/``; every record read back."""
    import os
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jobs = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(out_dir), "--jobs", str(jobs)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    _check(res.returncode == 0, "dryrun failed:\n" + "\n".join(lines[-40:])
           + res.stderr[-4000:])
    recs = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    skipped = [ln for ln in lines if ln.startswith("[skipped")]
    errors = [r for r in recs if r["status"] == "error"]
    _check(not errors, f"dryrun errors: {[r.get('error') for r in errors]}")
    ok = [r for r in recs if r["status"] == "ok"]
    wrong = [(r["arch"], r["shape"], r["mesh"]) for r in ok
             if not r["partitioned"]
             or not {"flops", "bytes", "wire_bytes", "wire_bytes_by_kind"}
             <= set(r["per_device"])]
    _check(not wrong, f"dryrun records of the wrong form: {wrong}")
    walks = {(r["arch"], r["shape"], r["mesh"]): r["walk_s"] for r in ok}
    table = [{"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
              "chips": r["chips"], "desc": r["desc"],
              "partitioned": r["partitioned"],
              "microbatches": r["microbatches"],
              "per_device_gb": r["per_device_bytes"] / 1e9,
              "fits_hbm": r["fits_hbm"],
              "dominant": r["roofline"]["dominant"],
              "compute_s": r["roofline"]["compute_s"],
              "memory_s": r["roofline"]["memory_s"],
              "collective_s": r["roofline"]["collective_s"],
              "per_device_flops": r["per_device"]["flops"],
              "per_device_bytes": r["per_device"]["bytes"],
              "wire_bytes_by_kind": r["per_device"]["wire_bytes_by_kind"],
              "collectives_by_kind": r["per_device"]["collectives_by_kind"],
              "useful_fraction": r["roofline"]["useful_fraction"],
              "mfu_bound": r["roofline"]["mfu_bound"],
              "walk_s": r["walk_s"]} for r in ok]
    return {"ok": len(ok), "skipped": len(skipped), "errors": len(errors),
            "partitioned": sum(r["partitioned"] for r in ok),
            "walk_s_total": sum(walks.values()), "wall_s": wall,
            "jobs": jobs,
            "cells": table}


def _tensors_of(m, tree) -> list:
    torch = m["torch"]
    leaves = m["torch"].utils._pytree.tree_leaves(
        m["cells_mod"]._struct(tree))
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _flat_outputs(m, out, prefix="") -> dict:
    """{path: tensor} of a step's outputs (a train step's: the
    parameters and the loss metrics), placed leaves whole."""
    torch = m["torch"]
    if isinstance(out, m["train_loop"].TrainState):
        out = {"params": dict(out.params.named_parameters())}
    if isinstance(out, dict):
        items = out.items()
    elif isinstance(out, (tuple, list)):
        items = enumerate(out)
    else:
        if not isinstance(out, torch.Tensor):
            return {}
        t = out.detach()
        return {prefix: t.full_tensor() if hasattr(t, "full_tensor") else t}
    flat = {}
    for k, v in items:
        flat.update(_flat_outputs(m, v, f"{prefix}.{k}" if prefix
                                  else str(k)))
    return flat


def _vs_whole(m, got: dict, want: dict) -> dict:
    """The partitioned step's outputs against the whole step's: bit
    equality, else the first differing output (in output order) and the
    worst error against VS_WHOLE_TOL."""
    torch = m["torch"]
    _check(got.keys() == want.keys(), f"outputs differ in their leaves: "
           f"{sorted(set(got) ^ set(want))}")
    got = {k: v.cpu() for k, v in got.items()}
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    rec = {"bit_equal": not differ, "leaves": len(want),
           "differing": len(differ),
           "first_differing": differ[0] if differ else None,
           "normalized_err": 0.0}
    for k in differ:
        w = want[k].float()
        err = float((got[k].float() - w).abs().max())
        rec["normalized_err"] = max(rec["normalized_err"],
                                    err / max(float(w.abs().max()), 1e-30))
    return rec


def _check_cell(m, name: str, mesh, whole_out=None) -> tuple:
    """(b) one check cell: built on CUDA (random weights, seed 0) and on
    meta; a warm-up step, DRYRUN_RUNS steps between CUDA events (gaps
    included) after the peak is reset, then a walk of the CUDA step and
    of the meta one under ``op_cost``, and a step under
    ``FlopCounterMode``.  On a ``MeshShape`` (1 x 1), the whole
    (unplaced) step, timed only: its outputs come back for the
    partitioned run's `whole_out`, which its own outputs must equal.
    Returns (record, the last timed step's outputs)."""
    torch = m["torch"]
    cm = m["cells_mod"]
    arch, kind, seq, batch, micro, layers, kv_quant = DRYRUN_CHECKS[name]
    shape = m["ShapeConfig"](f"check_{kind}", seq, batch, kind)
    kw = {}
    if layers is not None:
        kw["cfg"] = m["get_config"](arch).replace(num_layers=layers)
    if kind == "train":
        kw["tc"] = m["TrainConfig"](microbatch=micro, remat="full",
                                    learning_rate=TRAIN_LR)
    if kv_quant:
        kw["kv_quant"] = True
    timed_only = isinstance(mesh, m["mesh_mod"].MeshShape)
    if not timed_only:
        meta = cm.build_cell(arch, shape, mesh, device="meta", **kw)
        meta_cost, meta_out = meta.walk()
        del meta, meta_out
        _free(torch)
    cell = cm.build_cell(arch, shape, mesh, device="cuda", **kw)
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in _tensors_of(m, cell.args))
    _zero_counts(m)
    cell.run()                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(DRYRUN_RUNS):
        out = cell.run()
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b) / DRYRUN_RUNS
    peak = torch.cuda.max_memory_allocated()
    counts = _counts(m)
    routes = dict(m["fa_ops"].launches_by_route)
    outputs = _flat_outputs(m, out)
    del out
    if timed_only:      # kept on the host while the partitioned run runs
        outputs = {k: v.cpu() for k, v in outputs.items()}
        rec = {"arch": arch, "shape": [batch, seq], "kind": kind,
               "desc": cell.static_desc, "partitioned": False,
               "step_ms": step_ms, "peak_gb": peak / 1e9,
               "launches": counts, "flash_launches_by_route": routes}
        del cell
        _free(torch)
        return rec, outputs
    vs_whole = _vs_whole(m, outputs, whole_out)
    _check(vs_whole["bit_equal"] or vs_whole["normalized_err"] <= VS_WHOLE_TOL,
           f"{name}: the partitioned step differs from the whole one "
           f"beyond {VS_WHOLE_TOL}: {vs_whole}")
    del outputs
    cuda_cost, cuda_out = cell.walk()
    torch.cuda.synchronize()
    from torch.utils.flop_counter import FlopCounterMode
    with m["shd"].axis_rules(cell.mesh if cell.partitioned else None,
                             cell.rules):
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)
    torch.cuda.synchronize()
    counter_flops = fc.get_total_flops()
    cost = cell.cost((cuda_cost, cuda_out))
    roof = m["roof_analysis"].analyze(
        cost, n_chips=1, model_flops=m["api"].model_flops(cell.cfg, shape),
        chip=m["H100"], per_device=cell.partitioned)
    state = cell.state_bytes_per_device(cuda_out)
    placed = cell.arg_bytes_per_device()
    rec = {
        "arch": arch, "shape": [batch, seq], "kind": kind,
        "desc": cell.static_desc, "microbatches": cell.microbatches,
        "partitioned": cell.partitioned, "vs_whole": vs_whole,
        "step_ms": step_ms, "bound_ms": 1e3 * roof.total_s,
        "time_over_bound": step_ms / (1e3 * roof.total_s),
        "dominant": roof.dominant, "compute_ms": 1e3 * roof.compute_s,
        "memory_ms": 1e3 * roof.memory_s,
        "collective_ms": 1e3 * roof.collective_s,
        "flops": cost.flops, "bytes": cost.bytes,
        "product_flops": cuda_cost.product_flops,
        "flop_counter_flops": counter_flops,
        "meta_flops": meta_cost.flops, "meta_bytes": meta_cost.bytes,
        "cuda_walk_flops": cuda_cost.flops, "cuda_walk_bytes": cuda_cost.bytes,
        "declared": cuda_cost.declared,
        "collectives_by_kind": dict(cuda_cost.coll_op_counts),
        "state_gb": state / 1e9, "arg_gb": arg_bytes / 1e9,
        "placed_arg_gb": placed / 1e9, "peak_gb": peak / 1e9,
        "useful_fraction": roof.useful_fraction, "mfu_bound": roof.mfu_bound,
        "launches": counts, "flash_launches_by_route": routes}
    _check((cuda_cost.flops, cuda_cost.bytes)
           == (meta_cost.flops, meta_cost.bytes),
           f"{name}: the CUDA walk ({cuda_cost.flops}, {cuda_cost.bytes}) "
           f"differs from the meta walk ({meta_cost.flops}, "
           f"{meta_cost.bytes}); ops only on CUDA: "
           + str({k: v for k, v in cuda_cost.op_counts.items()
                  if meta_cost.op_counts.get(k) != v})
           + "; only on meta: "
           + str({k: v for k, v in meta_cost.op_counts.items()
                  if cuda_cost.op_counts.get(k) != v}))
    _check(cuda_cost.declared == meta_cost.declared,
           f"{name}: declared kernel costs differ between CUDA and meta")
    _check(placed == arg_bytes, f"{name}: placed argument bytes {placed} "
           f"!= the materialized arguments' {arg_bytes}")
    _check(state <= peak, f"{name}: state bytes {state} above the peak "
           f"{peak}")
    _check(roof.total_s * 1e3 <= step_ms, f"{name}: roofline bound "
           f"{1e3 * roof.total_s:.3f} ms above the measured step "
           f"{step_ms:.3f} ms (a counting fault)")
    _check(counter_flops == cuda_cost.product_flops,
           f"{name}: FlopCounterMode {counter_flops} != op_cost's product "
           f"FLOPs {cuda_cost.product_flops}")
    if cell.partitioned:
        used = ["rmsnorm", "add_rmsnorm"] + (
            ["rmsnorm_bwd", "add_rmsnorm_bwd"] if kind == "train" else [])
        if cell.cfg.family != "xlstm":          # attention-free
            used += (["flash_attention_bwd"] if kind == "train" else []) + (
                ["flash_attention"] if kind != "decode" else [])
        if kv_quant:   # 1 x 1: the cache whole, one launch
            used.append("decode_attention_q8")
        if cell.cfg.family == "moe":
            used += ["moe_dispatch"] + (["moe_dispatch_bwd"]
                                        if kind == "train" else [])
        if cell.cfg.family == "hybrid":   # the SSD, the gated norm
            used += ["rmsnorm_row_stat", "rmsnorm_row_fwd"] + (
                ["ssd_intra"] if kind != "decode" else []) + (
                ["ssd_intra_bwd", "rmsnorm_row_bwd"]
                if kind == "train" else [])
        _check(all(counts[k] > 0 for k in used),
               f"{name}: a kernel of the partitioned path never launched: "
               f"{ {k: counts[k] for k in used} }")
    del cell, cuda_out
    _free(torch)
    return rec, None


def dryrun_phase(m) -> dict:
    """The dry-run and roofline layer (``launch/{cells,dryrun}.py``,
    ``roofline/``):

    (a) every (arch x shape x mesh) cell of ``dryrun --all --mesh both``
        (meta tensors, separate processes; every cell partitioned on
        fake worlds of 256 and 512 ranks): no cell may fail, and every
        record must be partitioned;
    (b) the cells of DRYRUN_CHECKS, which fit one H100, at full width
        (and depth, but olmoe's and zamba2's train cells at the 7 of 16
        layers and 33 of 81 blocks their family training runs), in a
        world of one rank over NCCL
        (``make_test_mesh(1, 1)``): the CUDA walk's FLOPs, bytes and
        declared kernel costs equal the meta walk's exactly, the
        placements' argument bytes equal the materialized arguments',
        the state bytes stay at or below the measured peak, the roofline
        bound on ``H100`` stays at or below the measured step, and
        ``FlopCounterMode``'s product FLOPs equal ``op_cost``'s.  Each
        cell runs partitioned (DTensors; the flash and RMSNorm kernels,
        forward and in the train cells backward, launched on local
        shards) after its whole run (unplaced, on a 1 x 1
        ``MeshShape``), whose outputs its own must equal bit for bit
        (else within VS_WHOLE_TOL, the first differing output named);
        the MoE cells (olmoe decode,
        olmoe train at 7 of 16 layers, deepseek prefill) launch the
        dispatch kernel on the partitioned path (the global sort at 1 x
        1, where the a2a path does not apply), and in train its
        backward; the zamba2 cells (prefill and decode at 81 blocks,
        train at HYBRID_TRAIN's 33) the SSD kernel (not in decode) and
        the split-row norm's kernels for the gated norm, and in train
        their backwards; phi3's int8 decode (kv_quant: at 1 x 1
        the cache is whole, so the one-launch int8 kernel),
        whisper-tiny's train, prefill and decode (4 + 4 layers, 1500
        frames), and xlstm-125m's train (320 tokens, so that both walks
        take the quadratic fit), prefill and decode at 12 of 12 layers,
        their RMSNorm kernels (and in train their backwards) launched on
        local shards.  Each check cell is a path: the kernel counts are
        zeroed before its warm-up and read after its timed steps."""
    torch = m["torch"]
    _free(torch)
    out = {"all": _dryrun_all(m)}
    dr = out["all"]
    print(f"[dryrun] ok {dr['ok']} cells ({dr['partitioned']} partitioned), "
          f"skipped {dr['skipped']}, errors {dr['errors']}; walks "
          f"{dr['walk_s_total']:.1f} s in total, {dr['wall_s']:.1f} s wall "
          f"over {dr['jobs']} processes", flush=True)
    mesh_mod = m["mesh_mod"]
    _, started = mesh_mod.init_world("cuda")
    try:
        mesh = mesh_mod.make_test_mesh(1, 1)
        whole_mesh = mesh_mod.MeshShape(("data", "model"), (1, 1))
        out["checks"], out["whole"] = {}, {}
        for name in DRYRUN_CHECKS:
            out["whole"][name], whole = _check_cell(m, name, whole_mesh)
            rec, _ = _check_cell(m, name, mesh, whole_out=whole)
            del whole
            _free(torch)
            out["checks"][name] = rec
            vs = rec["vs_whole"]
            print(f"[dryrun] {name} {rec['arch']} {rec['desc']} "
                  f"{rec['shape']} partitioned {rec['partitioned']}: "
                  f"{rec['step_ms']:.2f} ms a step (whole "
                  f"{out['whole'][name]['step_ms']:.2f} ms; bit-equal "
                  f"{vs['bit_equal']}, first differing "
                  f"{vs['first_differing']}, normalized error "
                  f"{vs['normalized_err']:.3g}), bound "
                  f"{rec['bound_ms']:.2f} ms ({rec['dominant']}), "
                  f"time / bound {rec['time_over_bound']:.3f}; state "
                  f"{rec['state_gb']:.2f} GB, peak {rec['peak_gb']:.2f} GB",
                  flush=True)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return out


CLAIM_CONFIGS = [(2, 2), (2, 8), (8, 2), (8, 8)]      # test_paper_claims.py
SIMT_REPROFILE = 2      # profiles of a Fig 9 cell beyond the first, at most
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


class _SmClock:
    """``nvidia-smi``'s SM clock (MHz) sampled every 100 ms while the
    block runs: ``mhz`` is the median (None if nothing was read)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        self.mhz = statistics.median(vals) if vals else None
        return False


def _clocks(ns: float, mhz) -> float | None:
    """SM clocks in `ns` nanoseconds at `mhz` (None if not read)."""
    return ns * mhz / 1e3 if mhz else None


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
    grid_launches, reprofiled = 0, {}
    t0 = time.perf_counter()
    with _SmClock() as clock:
        for name, (kw, ml) in FIG9_BENCHES.items():
            for w, t in FIG9_CONFIGS:
                cell = f"{name}/{w}w{t}t"
                # the profiler drops a kernel's record at times (47 of 48
                # once): a cell whose profile shows fewer kernels than
                # its wrapper launched is run and profiled again, up to
                # SIMT_REPROFILE times; every run is checked in full
                for attempt in range(1 + SIMT_REPROFILE):
                    m["simt_ops"].launches = 0
                    ((res, ok), calls), dev = _profiled_cell(
                        m, lambda: _recorded(
                            m, lambda: m["rodinia"].BENCHMARKS[name](
                                _simt_config(m, w, t, ml), device="cuda",
                                **kw)))
                    _check(ok, f"simt {cell} failed its numpy oracle")
                    want = {k: baseline[cell]["stats"][k] for k in keys}
                    got = {k: res.stats[k] for k in keys}
                    _check(got == want, f"simt {cell}: counters {got} != "
                           f"the committed baseline's {want}")
                    if dev["kernel"][1] >= m["simt_ops"].launches:
                        break
                    reprofiled[cell] = attempt + 1
                grid_launches += m["simt_ops"].launches
                stats[(name, w, t)] = res.stats
                cycles = res.stats["cycles"]
                cells[cell] = {
                    "cycles": cycles, "launches": dev["kernel"][1],
                    "kernel_ms": dev["kernel"][0],
                    "ns_per_cycle": 1e6 * dev["kernel"][0] / cycles,
                    "h2d_ms": dev["HtoD"][0], "d2h_ms": dev["DtoH"][0],
                    "bound": _simt_bound(calls[0][0], res.stats, len(calls),
                                         sum(len(c[1]) for c in calls))}
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mhz = clock.mhz
    for c in cells.values():
        c["sm_clocks_per_cycle"] = _clocks(c["ns_per_cycle"], mhz)
    n_launch = sum(c["launches"] for c in cells.values())
    want = len(cells) + len(FIG9_CONFIGS)       # gaussian launches twice
    _check(grid_launches == n_launch == want,
           f"simt grid: {grid_launches} wrapper launches, {n_launch} "
           f"profiled kernels, want {want}")
    total_cycles = sum(c["cycles"] for c in cells.values())
    kernel_ms = sum(c["kernel_ms"] for c in cells.values())
    ns_cycle = 1e6 * kernel_ms / total_cycles
    print(f"[simt] Fig 9: {len(cells)}/42 cells match the baseline, "
          f"{total_cycles} cycles in {kernel_ms:.2f} kernel ms "
          f"({ns_cycle:.1f} ns/cycle, {_clocks(ns_cycle, mhz)} SM clocks "
          f"a cycle at {mhz} MHz), {grid_launches} launches, "
          f"{wall:.2f} s wall; profiled again: {reprofiled}", flush=True)
    for c in NAMED_CELLS:
        print(f"[simt] {c}: {cells[c]['kernel_ms']:.4f} kernel ms, "
              f"{cells[c]['ns_per_cycle']:.1f} ns and "
              f"{cells[c]['sm_clocks_per_cycle']} SM clocks a cycle",
              flush=True)

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
        "reprofiled": reprofiled, "kernel_ms": kernel_ms,
        "kernel_ms_per_launch": kernel_ms / grid_launches,
        "ns_per_cycle": ns_cycle, "sm_mhz": mhz,
        "sm_clocks_per_cycle": _clocks(ns_cycle, mhz),
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
        "cell_ms": {c: [v["kernel_ms"], v["ns_per_cycle"],
                        v["sm_clocks_per_cycle"]]
                    for c, v in cells.items()}}


# ---------------------------------------------------------------------------
# the int8 KV-cache decode path: the decode_attention_q8 kernel
# ---------------------------------------------------------------------------

INT8_OPS = 1979e12                 # dense int8 tensor-core peak
Q8_CHECKS = {  # B, Smax, KV, G, D, per-slot lens, window
    "phi3": (2, 256, 32, 1, 96, (256, 256), None),
    "qwen2.5-32b": (2, 256, 8, 5, 128, (256, 200), None),
    "internvl": (2, 256, 8, 8, 128, (256, 131), None),
    "danube ring": (2, 4096, 8, 4, 80, (4100, 5000), 4096),
    "window 64, not a ring": (2, 256, 8, 4, 80, (200, 256), 64),
    "per-slot lens": (3, 256, 8, 5, 128, (1, 77, 256), None),
    "minitron G 3": (2, 256, 8, 3, 128, (256, 100), None),
    # scores too large for the blocks' shared memory: the scratch form
    "scratch form": (1, 131072, 2, 8, 128, (100000,), None)}
# the kernel's output against the plain version's sums over the
# kernel's own pq (max |Δ| / max |want|): fp32 rounding of ps, and bf16's
# of the output; pq may sit one step from the plain version's where
# pv/ps lands on a rounding tie within the two softmax sums' ulps, at
# no more than Q8_MAX_FLIPS of the entries
Q8_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
Q8_MAX_FLIPS = 1e-3
Q8_TIMING = (16, 32768, 8, 5, 128)  # qwen2.5-32b decode_32k, 16 of 128 slots
Q8_MODELS = ((PHI3, None), (QWEN, None), (OLMOE, None),
             (INTERNVL, INTERNVL_LAYERS))
Q8_PROMPT, Q8_NEW = 64, 8
# each Q8_MODELS path's own shape (one slot, Q8_PROMPT + Q8_NEW
# positions, its config's heads) at lens of its first step, one between
# and its last, checked beside Q8_CHECKS
Q8_PATH_LENS = (1, 37, Q8_PROMPT + Q8_NEW)
Q8_REDUCED_STEPS = 24              # danube's reduced ring of 16 wraps
# reduced fp32 decode, card vs CPU: a new k or v entry (or its fp16
# scale) quantized one step apart moves the logits by ~1e-3 of max
# |logit| (tests/test_torch_kv_q8.py measures the same against JAX)
Q8_REDUCED_TOL, Q8_REDUCED_FLIPS = 5e-3, 16


def _q8_compare(m, q, cache, lens, window, what) -> dict:
    """The kernel against its plain version on the same inputs: equal
    int32 scores where attended, pq at most one step apart at few
    entries, the output within Q8_TOL of the plain sums over the
    kernel's pq, and the same bits on a second run."""
    torch, ops = m["torch"], m["q8_ops"]
    Smax = cache["k"].shape[1]
    got, s_i32, pq = ops.decode_attention_q8_cuda(q, cache, lens,
                                                  window=window, debug=True)
    want, s_want, pq_want, ps = m["decode_attention_q8_ref"](
        q, cache, lens, window=window, debug=True)
    valid = m["valid_positions"](lens, Smax, window)[:, None, None, :]
    _check(torch.equal(torch.where(valid, s_want, 0), s_i32),
           f"{what}: int32 scores differ from the plain version's")
    apart = (pq.int() - pq_want.int()).abs()
    flips = int((apart != 0).sum())
    _check(int(apart.max()) <= 1 and flips <= Q8_MAX_FLIPS * apart.numel(),
           f"{what}: pq {flips} entries apart, up to {int(apart.max())}")
    redo = m["combine_pv"](pq, ps, cache["v"]).reshape(got.shape)
    dt = str(q.dtype).replace("torch.", "")
    err, rel = _rel_err(torch, got, redo, Q8_TOL[dt], what)
    again = ops.decode_attention_q8_cuda(q, cache, lens, window=window)
    _check(torch.equal(got, again), f"{what}: bits differ between runs")
    return {"max_abs_err": err, "normalized_err": rel,
            "vs_plain_output": float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()),
            "pq_flips": flips, "pq_entries": apart.numel(),
            "attended": int(valid.sum()), "pq": pq}


def kv_q8_checks(m) -> dict:
    """The kernel against its plain version at Q8_CHECKS and at each
    Q8_MODELS path's own shape, bf16 and fp32 q, from N(0, 1) caches
    quantized by ``quantize_kv``."""
    torch = m["torch"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    out = {}
    checks = dict(Q8_CHECKS)
    for arch, _ in Q8_MODELS:
        cfg = m["get_config"](arch)
        KV = cfg.num_kv_heads
        for n in Q8_PATH_LENS:
            checks[f"{arch} path, len {n}"] = (
                1, Q8_PROMPT + Q8_NEW, KV, cfg.num_heads // KV,
                cfg.resolved_head_dim, (n,), cfg.sliding_window)
    for name, (B, Smax, KV, G, D, lens, window) in checks.items():
        k, v = (torch.randn((B, Smax, KV, D), generator=g, device="cuda")
                for _ in range(2))
        (kq, ks), (vq, vs) = m["quantize_kv"](k), m["quantize_kv"](v)
        cache = dict(k=kq, v=vq, k_scale=ks, v_scale=vs)
        q = torch.randn((B, 1, KV * G, D), generator=g, device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            what = f"{name} {str(dt).replace('torch.', '')}"
            out[what] = _q8_compare(m, q.to(dt), cache,
                                    torch.tensor(lens, device="cuda"),
                                    window, f"decode_attention_q8 {what}")
            del out[what]["pq"]
            out[what]["shape"] = [B, Smax, KV, G, D]
    return out


def _q8_random(torch, g, B, S, KV, G, D):
    """bf16 q over full int8 caches of random payload and scales."""
    q = torch.randn((B, 1, KV * G, D), generator=g, device="cuda").bfloat16()
    cache = {n: torch.randint(-127, 128, (B, S, KV, D), generator=g,
                              device="cuda", dtype=torch.int8)
             for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        cache[n] = (torch.rand((B, S, KV), generator=g, device="cuda")
                    * 0.02 + 1e-3).half()
    return q, cache, torch.full((B,), S, device="cuda")


def _launches_per_call(torch, fn, prefix: str) -> int:
    """Launches of CUDA functions whose name contains `prefix` in one
    call of `fn`: the kernel nodes of a CUDA graph that captured the
    call, read from the graph's DOT dump.  Unlike ``torch.profiler``,
    which may drop some of a window's launches, a capture records every
    launch."""
    import tempfile
    fn()
    torch.cuda.synchronize()
    # kept (not instantiated and dropped at the end of the capture) so
    # that it can be dumped
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        dot = Path(tmp) / "call.dot"
        graph.debug_dump(str(dot))
        text = dot.read_text()
    del graph
    # each node's definition runs from its name and '[' to the next's
    nodes = re.split(r'"graph_\d+_node_\d+"\s*\[', text)[1:]
    _check(nodes, f"no node in the CUDA graph's dump: {text[:2000]}")
    return sum(prefix in node for node in nodes)


def kv_q8_timing(m, q8_ptxas: dict) -> dict:
    """At Q8_TIMING, bf16 q over full int8 caches of random payload and
    scales: the kernel against its plain version, then its device ms
    (CUDA-graph replays) and per-call ms, each launch's device ms under
    the profiler, its launches a call (the kernel nodes of a CUDA graph
    that captured one call), the plain version's (fp64
    products), and the bound: the bytes this run needs (every k row and
    scale, the v rows whose pq is not all 0, q and the output) at 3.35
    TB/s against its int8 products at the int8 peak.  Its plan (form,
    cluster size, shared bytes a block) and the clusters of it that fit
    on the card; `q8_ptxas`: every instance's registers and spill bytes
    (none may spill).  For context only, SDPA over a bf16 cache of the
    same shape: a different function, not a yardstick.  Then the device
    ms a call at each Q8_MODELS path's shape, all positions attended."""
    torch, F, ops = m["torch"], m["F"], m["q8_ops"]
    B, S, KV, G, D = Q8_TIMING
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    q, cache, lens = _q8_random(torch, g, B, S, KV, G, D)
    chk = _q8_compare(m, q, cache, lens, None, "decode_attention_q8 timing")
    v_rows = int((chk.pop("pq") != 0).any(dim=2).sum())
    pl = ops.plan(B, S, KV, G, D)
    instances = {k: v for k, v in q8_ptxas.items() if k.startswith("q8_")}
    _check(all(v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0
               for v in instances.values()),
           f"decode_attention_q8 spills: {instances}")
    out = {"shape": [B, S, KV, G, D], "check": chk, "v_rows_read": v_rows,
           "v_rows": B * KV * S, "plan": pl._asdict(),
           "active_clusters": ops.active_clusters(pl, B, KV, D),
           "ptxas": instances}

    def kernel():
        return ops.decode_attention_q8_cuda(q, cache, lens)

    def plain():
        return m["decode_attention_q8_ref"](q, cache, lens)

    out.update(ms=_device_ms(torch, kernel), call_ms=_time_ms(torch, kernel),
               plain_ms=_device_ms(torch, plain, reps=5, inner=2),
               plain_call_ms=_time_ms(torch, plain, reps=5, inner=2),
               library_ms=None)
    out["launch_ms"] = _launch_ms(torch, kernel, "q8_")
    out["launches_per_call"] = _launches_per_call(torch, kernel, "q8_")
    _check(out["launches_per_call"] == 1,
           f"decode_attention_q8: {out['launches_per_call']} launches a call")
    nbytes = (B * S * KV * D + v_rows * D + 2 * 2 * B * S * KV
              + 2 * 2 * B * KV * G * D + 8 * B)
    out.update(_bound(nbytes, 4.0 * B * KV * G * S * D, INT8_OPS))
    del cache
    qh = q.reshape(B, KV * G, 1, D)
    kb, vb = (torch.randn((B, KV, S, D), generator=g, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    out["sdpa_bf16_cache_ms"] = _device_ms(
        torch, lambda: F.scaled_dot_product_attention(qh, kb, vb,
                                                      enable_gqa=True))
    out["sdpa_bf16_cache_bound_ms"] = 1e3 * (2 * 2 * B * KV * S * D
                                             ) / HBM_BYTES_PER_S
    del kb, vb
    _free(torch)
    out["path_ms"] = {}
    for arch, _ in Q8_MODELS:
        cfg = m["get_config"](arch)
        KV = cfg.num_kv_heads
        shape = (1, Q8_PROMPT + Q8_NEW, KV, cfg.num_heads // KV,
                 cfg.resolved_head_dim)
        q, cache, lens = _q8_random(torch, g, *shape)
        out["path_ms"][arch] = {
            "shape": list(shape), "plan": ops.plan(*shape)._asdict(),
            "ms": _device_ms(torch, lambda: ops.decode_attention_q8_cuda(
                q, cache, lens))}
    return out


def kv_q8_path(m, cfg, params, prompt) -> dict:
    """The int8 decode path of a full-width model: `prompt` fed one token
    a step through ``api.forward(mode="decode")`` from empty int8
    caches (``kv_quant``), then Q8_NEW greedy tokens; every launch count
    zeroed just before, read just after.  Then the same input tokens on
    a bf16 cache: the greedy tokens that agree and each step's logit
    cosine with the int8 run are readings (random weights), not gates."""
    torch, api = m["torch"], m["api"]
    steps = len(prompt) + Q8_NEW

    def run(kv_quant, feed):
        caches = api.init_caches(cfg, 1, steps, device="cuda",
                                 kv_quant=kv_quant)
        gc.collect()
        _zero_counts(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        inputs, out, logits = [], [], []
        for i in range(steps):
            tok = feed[i] if feed else (prompt[i] if i < len(prompt)
                                        else out[-1])
            inputs.append(tok)
            step, _, caches = api.forward(
                params, {"tokens": torch.tensor([[tok]], dtype=torch.int32,
                                                device="cuda")},
                cfg, mode="decode", caches=caches)
            logits.append(step[0, -1].float())
            if i >= len(prompt) - 1:
                out.append(int(logits[-1].argmax()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logits = torch.stack(logits)
        _check(bool(torch.isfinite(logits).all()),
               f"{cfg.name}: non-finite logits (kv_quant={kv_quant})")
        return {"inputs": inputs, "out": out, "logits": logits,
                "ms_per_step": 1e3 * wall / steps,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": _counts(m),
                "flash_launches_by_route": dict(
                    m["fa_ops"].launches_by_route)}

    q8 = run(True, None)
    bf = run(False, q8["inputs"])
    cos = [_cosine(torch, a, b) for a, b in zip(q8["logits"], bf["logits"])]
    n, nb = q8["launches"], bf["launches"]
    _check(n["decode_attention_q8"] == cfg.num_layers * steps
           and nb["decode_attention_q8"] == 0,
           f"{cfg.name}: decode_attention_q8 launches {n} int8, {nb} bf16")
    for name in ("rmsnorm", "add_rmsnorm") + (
            ("moe_dispatch",) if cfg.is_moe else ()):
        _check(n[name] > 0, f"{cfg.name} int8 decode: no {name} launch")
    rec = {"arch": cfg.name, "mode": "api.forward decode, int8 KV",
           "layers": cfg.num_layers, "steps": steps,
           "prompt_tokens": len(prompt), "out": [q8["out"]],
           "tokens_digest": token_digest([q8["out"]]),
           "bf16_tokens_digest": token_digest([bf["out"]]),
           "equal_greedy_tokens": sum(a == b for a, b in zip(q8["out"],
                                                             bf["out"])),
           "greedy_tokens": len(q8["out"]),
           "logit_cosine_vs_bf16": cos,
           "ms_per_step": q8["ms_per_step"],
           "bf16_ms_per_step": bf["ms_per_step"],
           "peak_mem_gb": q8["peak_mem_gb"],
           "bf16_peak_mem_gb": bf["peak_mem_gb"], "launches": n,
           "flash_launches_by_route": q8["flash_launches_by_route"]}
    print(f"[kv_q8] {cfg.name} ({cfg.num_layers} layers): int8 tokens "
          f"{q8['out']} ({rec['tokens_digest']}), bf16 {bf['out']} "
          f"({rec['bf16_tokens_digest']}), equal "
          f"{rec['equal_greedy_tokens']}/{len(q8['out'])}, logit cosine vs "
          f"bf16 min {min(cos):.6f} last {cos[-1]:.6f}, "
          f"{q8['ms_per_step']:.2f} ms a step (bf16 "
          f"{bf['ms_per_step']:.2f}), peak {q8['peak_mem_gb']:.2f} GB, "
          f"decode_attention_q8 launches {n['decode_attention_q8']}",
          flush=True)
    return rec


def kv_q8_reduced(m) -> dict:
    """Reduced fp32 phi3, danube and qwen, two layers and two slots: 24
    decode steps on int8 caches, the card (kernel) against the CPU
    (plain version) on the same weights and tokens: the logits within
    Q8_REDUCED_TOL of max |logit| at every step, and the caches equal
    but for Q8_REDUCED_FLIPS entries one step apart (int8) or scales
    within an fp16 ulp."""
    torch, api, bridge = m["torch"], m["api"], m["bridge"]
    out = {}
    for arch in (PHI3, DANUBE, QWEN):
        cfg = m["reduced_config"](arch).replace(num_layers=2,
                                                dtype="float32")
        cpu = api.build_params(cfg, torch.Generator().manual_seed(SEED),
                               device="cpu")
        gpu = bridge.from_numpy(bridge.to_numpy(cpu), cfg, device="cuda")
        max_len = 40
        cc = api.init_caches(cfg, 2, max_len, device="cpu", kv_quant=True)
        cg = api.init_caches(cfg, 2, max_len, device="cuda", kv_quant=True)
        toks = torch.randint(0, cfg.vocab_size, (Q8_REDUCED_STEPS, 2, 1),
                             generator=torch.Generator().manual_seed(SEED),
                             dtype=torch.int32)
        errs = []
        _zero_counts(m)
        for t in toks:
            want, _, cc = api.forward(cpu, {"tokens": t}, cfg, mode="decode",
                                      caches=cc)
            got, _, cg = api.forward(gpu, {"tokens": t.cuda()}, cfg,
                                     mode="decode", caches=cg)
            errs.append(float((got.cpu() - want).abs().max()
                              / want.abs().max()))
        n = _counts(m)["decode_attention_q8"]
        flips = 0
        for name in ("k", "v", "k_scale", "v_scale"):
            a, b = cg["stage1"][name].cpu(), cc["stage1"][name]
            if a.dtype == torch.int8:
                d = (a.int() - b.int()).abs()
                _check(int(d.max()) <= 1,
                       f"reduced {arch} int8 {name} {int(d.max())} apart")
            else:
                d = a.view(torch.int16) != b.view(torch.int16)
                _check(bool(((a.float() - b.float()).abs()
                             <= 2e-3 * b.float().abs()).all()),
                       f"reduced {arch} {name} beyond an fp16 ulp")
            flips += int((d != 0).sum())
        ring = cc["stage1"]["k"].shape[2]
        out[arch] = {"max_normalized_err": max(errs), "errs": errs,
                     "cache_entries_apart": flips, "cache_slots": ring,
                     "launches": n}
        _check(max(errs) <= Q8_REDUCED_TOL and flips <= Q8_REDUCED_FLIPS
               and n == cfg.num_layers * Q8_REDUCED_STEPS,
               f"reduced fp32 {arch} int8 decode, card vs CPU: {out[arch]}")
    _check(out[DANUBE]["cache_slots"] < Q8_REDUCED_STEPS,
           "the reduced danube ring did not wrap")
    return out


# the split form (context-parallel decode): the timing shape's positions
# in 1, 4 and 16 blocks, as that many model ranks hold them (16: the
# production meshes' model axis), the exchanges done by torch on one
# card; per-slot lens for the checks, so that whole blocks are masked
Q8_SPLIT_BLOCKS = (1, 4, 16)
Q8_SPLIT_LENS = (32768, 1000, 20001, 32768, 2048, 2049, 31000, 1,
                 32768, 16384, 5, 32767, 8191, 24576, 100, 32768)
# a stage's statistic against its plain version's on the same inputs
# (max |Δ| / max |want|): the max of the scores is exact; the sums of
# exponentials and max |pv| differ by fp32 rounding (the order of a
# 32768-term sum, expf against torch's exp)
Q8_STAGE_TOL = {"decode_q8_scores": 0.0, "decode_q8_exp": 1e-5,
                "decode_q8_pv": 1e-5}
# the stages' kernels (``decode_attention_q8_stage`` launches the ring
# kernels for stages 0 and 3, the cluster kernel's stage instances for 1
# and 2), by the profiler's names and by ptxas's
Q8_STAGE_KERNELS = (r"q8_scores_kernel<",
                    r"q8_decode_kernel<\d+,\s*(false|0|\(bool\)0),\s*1>",
                    r"q8_decode_kernel<\d+,\s*(false|0|\(bool\)0),\s*2>",
                    r"q8_pq_kernel<")
Q8_STAGE_INSTANCES = r"q8_decode_kernel<\d+,0,[12]>|q8_(scores|pq)_kernel<\d+>"
# device ms a launch of stages 0..3 when stages 0 and 3 ran as the
# cluster kernel's stage instances: PERF.md's readings from PR 32 (a
# rank's block [16,2048,8,G 5,128] and the whole [16,32768,...], full
# lens; H100 80GB HBM3 at 700 W), printed beside this run's for
# reference and used in no check or result
Q8_SPLIT_CLUSTER_MS = {16: (0.02959, 0.00966, 0.01114, 0.03862),
                       1: (0.2659, 0.0669, 0.1101, 0.4209)}


def _q8_blocks(cache, n: int) -> list:
    """The cache's positions in `n` blocks [(cache, start)], as `n`
    ranks hold them (each block contiguous)."""
    S = cache["k"].shape[1]
    w = S // n
    return [({k: t[:, i * w:(i + 1) * w].contiguous()
              for k, t in cache.items()}, i * w) for i in range(n)]


def _q8_stage_checks(m, q, block, lens, smax) -> dict:
    """Each stage kernel on one block, its exchange the identity (the
    block alone), against its plain version fed the same exchanged
    statistic: the statistics within Q8_STAGE_TOL, the scores bit-equal
    to the plain stage's, the int32 sums equal to the exact products of
    the kernel's own pq, and pq at most one
    step from the plain version's at no more than Q8_MAX_FLIPS.  The pq
    stage's error is its sums times ps against the plain stage's (over
    the plain pq, so it shows the flips)."""
    torch, ops, plain = m["torch"], m["q8_ops"], m["q8_ref"].PLAIN_STAGES
    cache, start = block
    st_k, m_k = ops.STAGES.scores(q, cache, lens, None, start, smax)
    st_p, m_p = plain.scores(q, cache, lens, None, start, smax)
    out = {}

    def stat(name, got, want):
        err, rel = _rel_err(torch, got, want, Q8_STAGE_TOL[name],
                            f"{name} vs plain")
        out[name] = {"max_abs_err": err, "normalized_err": rel}
    stat("decode_q8_scores", m_k, m_p)
    _check(torch.equal(st_k["scratch"].view(st_p["x"].shape), st_p["x"]),
           "decode_q8_scores: scores differ from the plain stage's")
    out["decode_q8_scores"]["scores_bit_equal"] = True
    st_k, l_k = ops.STAGES.exp(st_k, m_k)
    st_p, l_p = plain.exp(st_p, m_k)
    stat("decode_q8_exp", l_k, l_p)
    st_k, pm_k = ops.STAGES.pv(st_k, l_k)
    st_p, pm_p = plain.pv(st_p, l_k)
    stat("decode_q8_pv", pm_k, pm_p)
    ps = torch.clamp(pm_k / torch.full_like(pm_k, 127.0), min=1e-20)
    sums, pq = ops.STAGES.pq(st_k, ps, True)
    sums_p, pq_p = plain.pq(st_p, ps, True)
    exact = m["q8_ref"]._int_dot("bkgs,bskd->bkgd", pq, cache["v"])
    _check(torch.equal(sums, exact), "decode_q8_pq: int32 sums differ from "
           "the exact products of its pq")
    apart = (pq.int() - pq_p.int()).abs()
    flips = int((apart != 0).sum())
    _check(int(apart.max()) <= 1 and flips <= Q8_MAX_FLIPS * apart.numel(),
           f"decode_q8_pq: pq {flips} entries apart from the plain "
           f"version's, up to {int(apart.max())}")
    got, want = (t.float() * ps[..., None] for t in (sums, sums_p))
    _check(bool(torch.isfinite(got).all()), "decode_q8_pq: non-finite sums")
    err = float((got - want).abs().max())
    out["decode_q8_pq"] = {"max_abs_err": err,
                           "normalized_err": err / max(
                               float(want.abs().max()), 1e-30),
                           "pq_flips": flips,
                           "pq_entries": apart.numel(),
                           "v_rows_read": int((pq != 0).any(dim=2).sum())}
    return out


def kv_q8_split(m, q8_ptxas: dict) -> dict:
    """The split form (``q8_ops.decode_attention_q8_blocks``: four stage
    launches a block through ``decode_attention_q8_stage``: the ring
    kernels for the scores and pq, the cluster kernel for exp and pv) at
    Q8_TIMING, bf16 q over full int8 caches of random payload and scales:

    (a) each stage kernel against its plain version on a block of
        Q8_SPLIT_BLOCKS' largest split (one rank's positions) and on the
        whole cache (``_q8_stage_checks``);
    (b) the split form in Q8_SPLIT_BLOCKS blocks, per-slot lens
        Q8_SPLIT_LENS (whole blocks masked), the exchanges a reduction
        over the blocks: against ``decode_attention_q8_ref`` (pq at most
        one step apart at no more than Q8_MAX_FLIPS; the output within
        Q8_TOL of the plain sums over its own pq) and against the
        one-launch kernel (pq steps that differ, output error, bits);
        two runs the same bits.  Its main path: the launch counts are
        zeroed before the three split runs and read after them.  Then
        the context-parallel entry (``q8_ops.decode_attention_q8(...,
        group=, start=0, smax=)``) over a world of one rank on NCCL,
        whose exchanges are functional-collective all-reduces of CUDA
        tensors: the 1-block split run's bits, each stage once more;
    (c) at full lens, each split's device ms a call (CUDA graphs, the
        exchanges included), each stage's device ms a launch under the
        profiler, the plain stages' device ms on one block, and each
        stage's bound on one block: the bytes it must move (each input
        read once, each output written once: the fp32 scores between
        stages, the v rows whose pq is not 0) at 3.35 TB/s against its
        products at the int8 peak and the rest at the fp32 rate; the
        stage instances' ptxas registers and spill bytes."""
    torch, ops, plain = m["torch"], m["q8_ops"], m["q8_ref"].PLAIN_STAGES
    B, S, KV, G, D = Q8_TIMING
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    q, cache, full = _q8_random(torch, g, B, S, KV, G, D)
    lens = torch.tensor(Q8_SPLIT_LENS, device="cuda")
    n_max = max(Q8_SPLIT_BLOCKS)
    blocks = {n: _q8_blocks(cache, n) for n in Q8_SPLIT_BLOCKS}
    out = {"shape": [B, S, KV, G, D], "lens": list(Q8_SPLIT_LENS),
           "stage_checks": {
               "rank_block": _q8_stage_checks(m, q, blocks[n_max][1], lens,
                                              S),
               "whole": _q8_stage_checks(m, q, blocks[1][0], lens, S)}}
    want, _, pq_want, ps = m["decode_attention_q8_ref"](q, cache, lens,
                                                        debug=True)
    one, _, pq_one = ops.decode_attention_q8_cuda(q, cache, lens,
                                                  debug=True)
    _zero_counts(m)          # the split form's main path
    runs = {n: ops.decode_attention_q8_blocks(q, blocks[n], lens, smax=S,
                                              debug=True)
            for n in Q8_SPLIT_BLOCKS}
    torch.cuda.synchronize()
    out["launches"] = dict(ops.stage_launches)
    _check(out["launches"] == {k: sum(Q8_SPLIT_BLOCKS)
                               for k in ops.STAGE_NAMES},
           f"split form launches {out['launches']}")
    _, started = m["mesh_mod"].init_world("cuda")
    try:
        before = dict(ops.stage_launches)
        cp = ops.decode_attention_q8(q, cache, lens,
                                     group=torch.distributed.group.WORLD,
                                     start=0, smax=S)
        torch.cuda.synchronize()
        grew = {k: ops.stage_launches[k] - before[k] for k in before}
        backend = torch.distributed.get_backend()
    finally:
        if started:
            torch.distributed.destroy_process_group()
    out["group_entry"] = {"backend": backend, "stage_launches": grew,
                          "bit_equal_one_block": torch.equal(cp, runs[1][0])}
    _check(backend == "nccl" and grew == {k: 1 for k in ops.STAGE_NAMES}
           and out["group_entry"]["bit_equal_one_block"],
           f"decode_attention_q8(group=) over one NCCL rank: "
           f"{out['group_entry']}")
    del cp
    out["splits"] = {}
    for n, (got, pq) in runs.items():
        what = f"split decode_q8 in {n} block(s)"
        apart = (pq.int() - pq_want.int()).abs()
        flips = int((apart != 0).sum())
        _check(int(apart.max()) <= 1
               and flips <= Q8_MAX_FLIPS * apart.numel(),
               f"{what}: pq {flips} entries apart, up to {int(apart.max())}")
        redo = m["combine_pv"](pq, ps, cache["v"]).reshape(got.shape)
        err, rel = _rel_err(torch, got, redo, Q8_TOL["bfloat16"], what)
        again = ops.decode_attention_q8_blocks(q, blocks[n], lens, smax=S)
        _check(torch.equal(got, again), f"{what}: bits differ between runs")
        out["splits"][n] = {
            "max_abs_err": err, "normalized_err": rel,
            "pq_flips_vs_plain": flips,
            "vs_plain_output": float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()),
            "pq_steps_vs_one_launch": int((pq != pq_one).sum()),
            "vs_one_launch_output": float(
                (got.float() - one.float()).abs().max()
                / one.float().abs().max()),
            "bit_equal_one_launch": torch.equal(got, one)}
    del runs, want, pq_want, one, pq_one, blocks
    _free(torch)
    # (c) timings at full lens
    instances = {k: v for k, v in q8_ptxas.items()
                 if re.match(Q8_STAGE_INSTANCES, k)}
    _check(all(v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0
               for v in instances.values()),
           f"decode_attention_q8 stage spills: {instances}")
    _check(not instances or {"q8_scores_kernel<128>", "q8_pq_kernel<128>",
                             "q8_decode_kernel<128,0,1>",
                             "q8_decode_kernel<128,0,2>"} <= set(instances),
           f"decode_attention_q8 stage instances: {sorted(instances)}")
    out["ptxas"] = instances
    out["timing"] = {}
    for n in Q8_SPLIT_BLOCKS:
        parts = _q8_blocks(cache, n)
        rec = {"block": [B, S // n, KV, G, D]}

        def call():
            return ops.decode_attention_q8_blocks(q, parts, full, smax=S)
        rec["call_ms"] = _device_ms(torch, call, reps=10, inner=5)
        per = _launch_ms(torch, call, "q8_")
        # one block's work, as a rank holds it
        c0 = parts[0][0]
        st, mx = plain.scores(q, c0, full, None, 0, S)
        st1, l1 = plain.exp(st, mx)
        st2, pm = plain.pv(st1, l1)
        ps = torch.clamp(pm / torch.full_like(pm, 127.0), min=1e-20)
        _, pq = plain.pq(st2, ps, True)
        v_rows = int((pq != 0).any(dim=2).sum())
        nsc = B * KV * G * (S // n)
        stat = 4 * B * KV * G
        kb = B * (S // n) * KV
        work = {  # (bytes, int8 products, fp32 operations)
            "decode_q8_scores": (kb * D + 2 * kb + 2 * B * KV * G * D
                                 + 4 * nsc + stat, 2.0 * D * nsc, 3.0 * nsc),
            "decode_q8_exp": (8 * nsc + 2 * stat, 0.0, 2.0 * nsc),
            "decode_q8_pv": (8 * nsc + 2 * kb + 2 * stat, 0.0, 3.0 * nsc),
            "decode_q8_pq": (4 * nsc + v_rows * D + stat + stat * D,
                             2.0 * D * nsc, 2.0 * nsc)}
        plains = {
            "decode_q8_scores": lambda: plain.scores(q, c0, full, None, 0, S),
            "decode_q8_exp": lambda: plain.exp(st, mx),
            "decode_q8_pv": lambda: plain.pv(st1, l1),
            "decode_q8_pq": lambda: plain.pq(st2, ps)}
        for i, name in enumerate(ops.STAGE_NAMES):
            nbytes, i8, f32 = work[name]
            t_ops = i8 / INT8_OPS + f32 / FP32_FLOPS
            t_bytes = nbytes / HBM_BYTES_PER_S
            key = [k for k in per if re.match(Q8_STAGE_KERNELS[i], k)]
            rec[name] = {
                "ms": per[key[0]] if key else None,
                "plain_ms": _device_ms(torch, plains[name], reps=5,
                                       inner=2),
                "bytes": nbytes, "int8_ops": i8, "fp32_ops": f32,
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            _check(key, f"{name}: no launch under the profiler: {per}")
        rec["v_rows_read"], rec["v_rows"] = v_rows, kb
        out["timing"][n] = rec
        del parts, st, st1, st2, pq
        _free(torch)
    out["one_launch_ms"] = _device_ms(
        torch, lambda: ops.decode_attention_q8_cuda(q, cache, full))
    del cache
    _free(torch)
    return out


def kv_q8_phase(m, q8_ptxas: dict) -> dict:
    """The int8 KV-cache decode path: the kernel against its plain
    version (Q8_CHECKS), its timing (Q8_TIMING and the paths' shapes;
    `q8_ptxas`: its instances' ptxas usage), its split form
    (``kv_q8_split``), the four full-width model
    paths (Q8_MODELS, each on an otherwise empty card) and the reduced
    fp32 card-vs-CPU decode."""
    torch, np = m["torch"], m["np"]
    t0 = time.perf_counter()
    out = {"checks": kv_q8_checks(m)}
    brief = {k: {x: v[x] for x in ("normalized_err", "vs_plain_output",
                                    "pq_flips")}
             for k, v in out["checks"].items()}
    print(f"[kv_q8] kernel vs plain: {json.dumps(brief)}", flush=True)
    out["timing"] = kv_q8_timing(m, q8_ptxas)
    t = out["timing"]
    pl = t["plan"]
    print(f"[kv_q8] timing {t['shape']}: {t['ms']:.4f} device ms, "
          f"{t['call_ms']:.4f} per call, plain {t['plain_ms']:.3f}, bound "
          f"{t['bound_ms']:.4f} ({t['bound_by']}), SDPA over a bf16 cache "
          f"(another function) {t['sdpa_bf16_cache_ms']:.4f}; launches "
          f"{t['launch_ms']}, {t['launches_per_call']} a call; vs plain "
          f"output {t['check']['vs_plain_output']:.3e}", flush=True)
    print(f"[kv_q8] plan: {'on chip' if pl['on_chip'] else 'scratch'}, "
          f"cluster {pl['cluster']}, {pl['block_positions']} positions a "
          f"block, {pl['smem_bytes']} shared bytes a block, "
          f"{t['active_clusters']} clusters in flight; ptxas "
          f"{json.dumps(t['ptxas'])}", flush=True)
    print("[kv_q8] device ms a call at the paths' shapes: "
          + json.dumps({a: [v["shape"], v["ms"]]
                        for a, v in t["path_ms"].items()}), flush=True)
    out["split"] = sp = kv_q8_split(m, q8_ptxas)
    print(f"[kv_q8] split form {sp['shape']} in {list(Q8_SPLIT_BLOCKS)} "
          "blocks, vs plain and vs the one launch: " + json.dumps(
              {n: {k: r[k] for k in (
                  "normalized_err", "pq_flips_vs_plain", "vs_plain_output",
                  "pq_steps_vs_one_launch", "vs_one_launch_output",
                  "bit_equal_one_launch")}
               for n, r in sp["splits"].items()}), flush=True)
    stages = m["q8_ops"].STAGE_NAMES
    print("[kv_q8] split stages by blocks, [device ms a launch, bound ms, "
          "bound by, plain ms]: " + json.dumps(
              {n: dict({s: [r[s]["ms"], r[s]["bound_ms"], r[s]["bound_by"],
                            r[s]["plain_ms"]] for s in stages},
                       call_ms=r["call_ms"])
               for n, r in sp["timing"].items()})
          + f"; one launch {sp['one_launch_ms']:.4f} ms; launches "
          f"{json.dumps(sp['launches'])}; group entry "
          f"{json.dumps(sp['group_entry'])}; ptxas {json.dumps(sp['ptxas'])}; "
          f"stage checks {json.dumps(sp['stage_checks'])}", flush=True)
    print("[kv_q8] split stages, device ms a launch [this run, the cluster "
          "design's from PERF.md (PR 32, not this run)]: " + json.dumps(
              {n: {s: [sp["timing"][n][s]["ms"], was[i]]
                   for i, s in enumerate(stages)}
               for n, was in Q8_SPLIT_CLUSTER_MS.items()}), flush=True)
    rng = np.random.default_rng(SEED + 25)
    out["paths"] = {}
    for arch, layers in Q8_MODELS:
        cfg, params = _build_model(m, arch, layers)
        prompt = rng.integers(0, cfg.vocab_size, Q8_PROMPT).tolist()
        key = f"kv_q8_{arch}"
        out["paths"][key] = kv_q8_path(m, cfg, params, prompt)
        if layers is not None:
            out["paths"][key]["depth_cut"] = (
                f"{layers} of {m['get_config'](arch).num_layers} layers")
        del params
        _free(torch)
    out["reduced"] = kv_q8_reduced(m)
    out["seconds"] = time.perf_counter() - t0
    brief = {a: {k: v[k] for k in ("max_normalized_err",
                                   "cache_entries_apart", "launches")}
             for a, v in out["reduced"].items()}
    print(f"[kv_q8] reduced fp32 card vs cpu: {json.dumps(brief)}; phase "
          f"{out['seconds']:.1f}s", flush=True)
    return out


def _kernel_name(mangled: str) -> str:
    """kernel<template arguments> of an Itanium-mangled kernel name:
    ints and bools as numbers, ``float`` as fp32 and ``__nv_bfloat16``
    as bf16 (the arguments the port's kernels take)."""
    s = mangled[2:] if mangled.startswith("_Z") else mangled
    nested = s.startswith("N")
    s = s[1:] if nested else s
    name = ""
    while True:
        hit = re.match(r"\d+", s)
        if not hit:
            break
        n = int(hit.group(0))
        name, s = s[hit.end():hit.end() + n], s[hit.end() + n:]
        if not nested:
            break
    if not name:
        return mangled
    if not s.startswith("I"):
        return name
    args, s = [], s[1:]
    while s and not s.startswith("E"):
        hit = re.match(r"L[ib](n?)(\d+)E", s)  # int or bool; n: negative
        if hit:
            args.append(("-" if hit.group(1) else "") + hit.group(2))
            s = s[hit.end():]
        elif s.startswith("13__nv_bfloat16"):
            args.append("bf16")
            s = s[15:]
        elif s.startswith("f"):
            args.append("fp32")
            s = s[1:]
        else:
            break
    return f"{name}<{','.join(args)}>"


def ptxas_usage(report: str, pattern: str = r"") -> dict:
    """Registers, stack frame and spill bytes of each kernel in an ``nvcc
    -Xptxas -v`` report whose short name (kernel<template arguments>)
    matches `pattern`; ``warnings``: ptxas's warnings that mention
    wgmma, and its notes that it serialized wgmma instructions."""
    out: dict = {"warnings": [ln.strip() for ln in report.splitlines()
                              if "wgmma" in ln and ("arning" in ln
                                                    or "serialized" in ln)]}
    fn = entry = None
    for ln in report.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", ln)
        if hit:
            entry = hit.group(1)
            name = _kernel_name(entry)
            fn = name if re.search(pattern, name) else None
            if fn is not None:
                out[fn] = {}
            continue
        props = re.search(r"Function properties for (\S+)", ln)
        if props and props.group(1) != entry:
            fn = None            # a device function's frame, not the entry's
            continue
        if fn is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
        if spill:
            out[fn].update(zip(("stack_frame", "spill_stores",
                                "spill_loads"), map(int, spill.groups())))
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            out[fn]["registers"] = int(regs.group(1))
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
    print(f"[build] {len(reports)} kernels in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    ptxas = {name: ptxas_usage(rep) for name, rep in reports.items()}
    for name, usage in ptxas.items():  # every instance, by name
        print(f"[build] {name} registers and spills: {json.dumps(usage)}",
              flush=True)
    bwd_ptxas = ptxas["flash_attention_bwd"]

    simt = simt_phase(m)
    print(json.dumps({"simt": simt}), flush=True)
    errs = kernel_phase(m)
    print(f"[kernels] max abs error vs plain: {errs}", flush=True)
    norm_split = norm_split_phase(m)
    print(f"[kernels] split-row norm: {json.dumps(norm_split)}", flush=True)
    reduced = reduced_model_phase(m)
    print(f"[kernels] reduced fp32 prefill, card vs cpu: {reduced}",
          flush=True)

    serve = serve_phase(m)
    serve["zamba_long_context"] = long_context_phase(m)
    print(json.dumps({"serve": serve}), flush=True)
    kv_q8 = kv_q8_phase(m, ptxas.get("decode_attention_q8", {}))
    print(json.dumps({"kv_q8": kv_q8}), flush=True)

    timings = timing_phase(m)
    print(json.dumps({"timings": timings}), flush=True)

    train = train_phase(m)
    print(json.dumps({"train": train}), flush=True)
    mesh = mesh_phase(m)
    for form, run in mesh["danube"].items():
        print(f"[mesh] {DANUBE} {form}: " + ", ".join(
            f"step {s['step']} loss {s['loss']:.6f} gnorm "
            f"{s['grad_norm']:.6f} {1e3 * s['step_s']:.1f} ms"
            for s in run["steps"])
            + f"; NCCL all-reduces {run['all_reduces']}", flush=True)
    print(f"[mesh] olmoe MoE layer {mesh['a2a']['shape']}: forward device "
          f"ms {mesh['a2a']['forward_device_ms']}, bit-equal "
          f"{mesh['a2a']['bit_equal']}", flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    dryrun = dryrun_phase(m)
    print(json.dumps({"dryrun": dryrun}), flush=True)
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
    paths = {p: serve[p] for p in serve if isinstance(serve[p], dict)
             and "launches" in serve[p]}
    paths["train"] = train["train"]
    paths["train_moe"] = train["train_moe"]
    paths["train_hybrid"] = train["train_hybrid"]
    for key in NEW_TRAIN:
        paths[key] = train[key]
    paths["mesh_a2a"] = mesh["a2a"]
    for name, rec in dryrun["checks"].items():
        paths[f"dryrun_{name}"] = rec
    for name, rec in dryrun["whole"].items():
        paths[f"dryrun_{name}_whole"] = rec
    kernels = []
    for name, (source, replaces, main_shape) in sources.items():
        t = timings[name][main_shape]
        by_path = {p: paths[p]["launches"][name] for p in paths}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(
                errs[name], train["kernels"]["forward"].get(name, 0.0),
                train["family_kernels"]["norms"]["forward"].get(name, 0.0),
                max(train["family_kernels"]["forward"].values())
                if name == "flash_attention" else 0.0),
            "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "call_ms": t["call_ms"],
            "plain_call_ms": t["plain_call_ms"]})
        kernels[-1]["new_shapes"] = {
            "max_abs_err": {k: v for k, v in errs["new_shapes"].items()
                            if k.split()[0] == name},
            "timings": [t for t in timings[name] if t.get("new")]}
        if name == "moe_dispatch":
            kernels[-1]["mesh_a2a_timing"] = mesh["a2a"]["dispatch_timing"]
        if name == "flash_attention":
            kernels[-1]["new_shapes"]["normalized_err"] = \
                errs["noncausal_normalized"]
            kernels[-1]["train_shapes_max_abs_err"] = \
                train["family_kernels"]["forward"]
            kernels[-1]["window_timing"] = \
                train["new_flash_timings"]["zamba2 long-context forward"]
            routes = m["fa_ops"].ROUTES
            kernels[-1]["routes"] = {str(dt).replace("torch.", ""): r
                                     for dt, r in routes.items()}
            kernels[-1]["launches_by_route"] = {
                r: sum(paths[p]["flash_launches_by_route"][r] for p in paths)
                for r in routes.values()}
        _check(kernels[-1]["launches"] > 0, f"{name}: no launch on a path")
    # the backward kernels: the train path (full-width danube) is their
    # main path; timed at its shapes
    bwd_sources = {
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/models/attention.py:193"),
        "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/models/common.py:65"),
        "add_rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                            "src/repro/models/common.py:65")}
    for name, (source, replaces) in bwd_sources.items():
        t = train["timings"][name]
        by_path = {p: paths[p]["launches"][name] for p in paths}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": train["kernels"][name]["max_abs_err"],
            "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "call_ms": t.get("call_ms")})
        if name == "flash_attention_bwd":
            fam = train["family_kernels"]["flash_attention_bwd"]
            kernels[-1].update(
                same_work=t["same_work"], ptxas=bwd_ptxas,
                family_shapes={"max_abs_err": fam["max_abs_err"],
                               "normalized_err": fam["normalized_err"],
                               "timings": train["family_timings"][name]},
                new_forms={k: v for k, v in
                           train["new_flash_timings"].items()
                           if "fwd_ms" in v})
        if name != "flash_attention_bwd":
            # both norm forms at the new families' rows and widths
            fam = train["family_kernels"]["norms"][name]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             fam["max_abs_err"])
            kernels[-1]["family_shapes_normalized_err"] = \
                fam["normalized_err"]
        if name == "rmsnorm_bwd":
            kernels[-1]["instances_by_path"] = {
                p: paths[p]["profile"]["rmsnorm_bwd_instances"]
                for p in paths if "profile" in paths[p]}
        _check(by_path["train"] > 0, f"{name}: no launch on the train path")
    # the MoE dispatch's and SSD's backward kernels: their main paths are
    # the full-width olmoe and zamba2 train steps; timed at their shapes
    new_bwd = {
        "moe_dispatch_bwd": ("src/repro_torch/csrc/moe_dispatch.cu",
                             "src/repro/models/moe.py:110", "train_moe"),
        "ssd_intra_bwd": ("src/repro_torch/csrc/ssm_scan_bwd.cu",
                          "src/repro/models/ssm.py:98", "train_hybrid")}
    for name, (source, replaces, main_path) in new_bwd.items():
        t = train["family_timings"][name]
        chk = train["family_kernels"][name]
        by_path = {p: paths[p]["launches"][name] for p in paths}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": chk["max_abs_err"],
            "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "call_ms": t.get("call_ms")})
        if name == "moe_dispatch_bwd":
            kernels[-1].update(
                dropped_share=t["dropped_share"],
                skewed={key: t["skewed"][key] for key in (
                    "dropped_share", "ms", "plain_ms", "library_ms",
                    "bound_ms")})
        if name == "ssd_intra_bwd":
            kernels[-1].update(
                normalized_err=max(chk["normalized_err"].values()),
                plain_fp32_normalized_err=max(
                    chk["plain_fp32_normalized_err"].values()),
                kernel_ms=t["kernel_ms"],
                fp32_fma_bound_ms=t["fp32_fma_bound_ms"],
                ptxas=ptxas["ssm_scan_bwd"])
        _check(by_path[main_path] > 0,
               f"{name}: no launch on the {main_path} path")
    # the split-row norm (zamba2's gated norm, partitioned): its main
    # path is the zamba2 check cells' partitioned runs, where one rank
    # holds the whole row; checked and timed at their [4096, 7168] rows,
    # and on one of 16 ranks' blocks under "rank_block"
    for name in NORM_SPLIT_KERNELS:
        t = norm_split["timings"]["whole_row"][name]
        by_path = {p: paths[p]["launches"].get(name, 0) for p in paths}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": ("src/repro/models/common.py:65"
                         if name == "rmsnorm_row_bwd"
                         else "src/repro/kernels/rmsnorm/kernel.py:31"),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": norm_split["max_abs_err"]["whole_row"][name],
            "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "call_ms": t["call_ms"],
            "rank_block": {
                **norm_split["timings"]["rank_block"][name],
                "max_abs_err": norm_split["max_abs_err"]["rank_block"][
                    name]},
            "whole_row_kernels": norm_split["timings"]["whole_row"][
                "whole_row_kernels"],
            "one_block_bit_equal": norm_split["one_block_bit_equal"]})
        if name == "rmsnorm_row_stat":
            kernels[-1]["backward_form"] = norm_split["timings"][
                "whole_row"]["rmsnorm_row_stat (backward's)"]
        _check(by_path["dryrun_zamba2_train"] > 0,
               f"{name}: no launch on the partitioned zamba2 train path")
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
        "ns_per_cycle": cell["ns_per_cycle"],
        "sm_clocks_per_cycle": cell["sm_clocks_per_cycle"],
        "grid_ns_per_cycle": simt["ns_per_cycle"],
        "grid_sm_clocks_per_cycle": simt["sm_clocks_per_cycle"]})
    # the int8 decode kernel: its main paths are the four full-width
    # int8 decode paths; timed at qwen2.5-32b's decode_32k layer
    t = kv_q8["timing"]
    by_path = {p: v["launches"]["decode_attention_q8"]
               for p, v in kv_q8["paths"].items()}
    kernels.append({
        "name": "decode_attention_q8", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention_q8.cu",
        "replaces": "src/repro/models/attention.py:396",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in
                           list(kv_q8["checks"].values()) + [t["check"]]),
        "normalized_err": {k: c["normalized_err"]
                           for k, c in kv_q8["checks"].items()},
        "pq_flips": {k: c["pq_flips"] for k, c in kv_q8["checks"].items()},
        "vs_plain_output": {k: c["vs_plain_output"]
                            for k, c in kv_q8["checks"].items()},
        "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "call_ms": t["call_ms"],
        "plain_call_ms": t["plain_call_ms"], "launch_ms": t["launch_ms"],
        "launches_per_call": t["launches_per_call"], "plan": t["plan"],
        "path_ms": {a: v["ms"] for a, v in t["path_ms"].items()},
        "sdpa_over_a_bf16_cache_ms (another function)":
            t["sdpa_bf16_cache_ms"]})
    _check(all(n > 0 for n in by_path.values()),
           f"decode_attention_q8: a path launched it no time: {by_path}")
    kernels[-1]["launches_by_path"].update(
        {p: paths[p]["launches"]["decode_attention_q8"] for p in paths
         if paths[p]["launches"].get("decode_attention_q8")})
    kernels[-1]["launches"] = sum(kernels[-1]["launches_by_path"].values())
    # its split form's four stages: their main path is the split check
    # at Q8_TIMING (one rank's block of the largest split timed)
    sp = kv_q8["split"]
    n_max = max(Q8_SPLIT_BLOCKS)
    for name in m["q8_ops"].STAGE_NAMES:
        t = sp["timing"][n_max][name]
        chk = sp["stage_checks"]["rank_block"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention_q8.cu",
            "replaces": "src/repro/models/attention.py:396",
            "launches": sp["launches"][name],
            "launches_by_path": {"kv_q8_split": sp["launches"][name]},
            "max_abs_err": chk["max_abs_err"],
            "shape": sp["timing"][n_max]["block"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "whole_cache": {k: sp["timing"][1][name][k]
                            for k in ("ms", "plain_ms", "bound_ms")},
            "split_normalized_err": {
                n: r["normalized_err"] for n, r in sp["splits"].items()}})
        _check(sp["launches"][name] > 0, f"{name}: no launch on its path")
    print(f"[done] {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
