"""Where the split int8 decode's ring kernels (stages 0 and 3,
``q8_scores_kernel`` and ``q8_pq_kernel``) spend a launch, read from
inside the kernels, on one card (Nsight Compute does not run there).

    python experiments/decode_q8_ring_probe.py

Builds a copy of ``csrc/decode_attention_q8.cu`` into
``build/ring_probe/`` with clocks around each ring kernel's loop: every
block records the global timer at its start and end, and its thread 0
the SM cycles it spent waiting for a ring slot (``cp.async.wait_group``
and the block barrier; the first slot apart), issuing copies and
computing.  The port's own wrapper then runs each stage alone on the
first block of ``chip_smoke.Q8_TIMING`` ([16,32768,8,G 5,128]) in 16
and in 1 position blocks, through the probed library, and prints one
JSON line a stage and shape: the launch's span on the global timer, the
spread of the blocks' starts and ends, their mean length, and the mean
share of each part of the loop.  The probes cost a few instructions an
item, so the spans run a little above the unprobed times.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ring_probe"
SLOTS = 12          # a block's record: start, end, wait0, wait, issue,
                    # compute, items, smid, and of stage 0: the reads of q
                    # and the stores of the scores (in compute), its
                    # producer warp's issue and its waits for a free slot

PROBE_DEFS = r"""
__device__ unsigned long long q8_probe[2][4096][12];
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned probe_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define PROBE_BEGIN \
  const unsigned long long pr_g0 = probe_ns(); \
  long long pr_t = clock64(), pr_w0 = 0, pr_w = 0, pr_i = 0, pr_c = 0;
#define PROBE_LAP(acc) { const long long pr_n = clock64(); \
  acc += pr_n - pr_t; pr_t = pr_n; }
#define PROBE_PRODUCER \
  if (threadIdx.x % 32 == 0 && blockIdx.x < 4096) { \
    q8_probe[0][blockIdx.x][10] = pr_i; q8_probe[0][blockIdx.x][11] = pr_w; }
#define PROBE_END(stage, items) \
  if (threadIdx.x == 0 && blockIdx.x < 4096) { \
    unsigned long long* r = q8_probe[stage][blockIdx.x]; \
    r[0] = pr_g0; r[1] = probe_ns(); r[2] = pr_w0; r[3] = pr_w; \
    r[4] = pr_i; r[5] = pr_c; r[6] = items; r[7] = probe_smid(); \
    r[8] = pr_q; r[9] = pr_st; }
"""

READER = r"""
extern "C" int q8_probe_read(void* dst, int stage) {
  return (int)cudaMemcpyFromSymbol(dst, q8_probe, sizeof(q8_probe[0]),
                                   stage * sizeof(q8_probe[0]));
}
extern "C" int q8_probe_clear() {
  static unsigned long long zero[2][4096][12];
  return (int)cudaMemcpyToSymbol(q8_probe, zero, sizeof(zero));
}
"""

# the loops as the source has them, and their probed forms
SCORES_LOOP = """  if (producer) {
    for (int k = 0; k < count; ++k) {
      const int u = k % kScoresRing;
      if (k >= kScoresRing)
        hopper::mbar_wait(empty(u), (k / kScoresRing - 1) & 1);
      issue(k, u);
    }
    cp_async_wait<0>();
    return;
  }
  for (int k = 0; k < count; ++k) {
    const int u = k % kScoresRing;
    hopper::mbar_wait(bar(u), (k / kScoresRing) & 1);
    compute(k, u);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(u));
  }
  flush();
}"""
SCORES_PROBED = """  PROBE_LAP(pr_i)
  if (producer) {
    for (int k = 0; k < count; ++k) {
      const int u = k % kScoresRing;
      if (k >= kScoresRing)
        hopper::mbar_wait(empty(u), (k / kScoresRing - 1) & 1);
      PROBE_LAP(pr_w)
      issue(k, u);
      PROBE_LAP(pr_i)
    }
    cp_async_wait<0>();
    PROBE_PRODUCER
    return;
  }
  for (int k = 0; k < count; ++k) {
    const int u = k % kScoresRing;
    hopper::mbar_wait(bar(u), (k / kScoresRing) & 1);
    if (k == 0) PROBE_LAP(pr_w0) else PROBE_LAP(pr_w)
    compute(k, u);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(u));
    PROBE_LAP(pr_c)
  }
  flush();
  PROBE_LAP(pr_c)
  PROBE_END(0, count)
}"""
PQ_LOOP = """#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < count) issue_pv(u, u);
    cp_async_commit();
  }
  for (int k = 0; k < count + kPqAhead; ++k) {
    // pv of tile k and v of tile k - kPqAhead are in; the slots of the
    // tiles before them are free
    cp_async_wait<kPqAhead - 1>();
    __syncthreads();
    if (k + kAhead < count) issue_pv(k + kAhead, (k + kAhead) % kSRing);
    if (k < count) pq_and_v(k, k % kSRing, k % kVRing);
    cp_async_commit();
    if (k >= kPqAhead) pv(k - kPqAhead, (k - kPqAhead) % kVRing);
  }
  flush();
  cp_async_wait<0>();
}"""
PQ_PROBED = """PROBE_BEGIN
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < count) issue_pv(u, u);
    cp_async_commit();
  }
  PROBE_LAP(pr_i)
  for (int k = 0; k < count + kPqAhead; ++k) {
    cp_async_wait<kPqAhead - 1>();
    __syncthreads();
    if (k == 0) PROBE_LAP(pr_w0) else PROBE_LAP(pr_w)
    if (k + kAhead < count) issue_pv(k + kAhead, (k + kAhead) % kSRing);
    if (k < count) pq_and_v(k, k % kSRing, k % kVRing);
    cp_async_commit();
    PROBE_LAP(pr_i)
    if (k >= kPqAhead) pv(k - kPqAhead, (k - kPqAhead) % kVRing);
    PROBE_LAP(pr_c)
  }
  flush();
  cp_async_wait<0>();
  PROBE_LAP(pr_c)
  PROBE_END(1, count)
}"""


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# stage 0's compute, in parts: its reads of q and its stores
SCORES_PARTS = (
    ("  const RingLayout L = ring_layout(0, p.G, D);\n",
     "  const RingLayout L = ring_layout(0, p.G, D);\n"
     "  long long pr_q = 0, pr_st = 0;\n"),
    ("      if (qbk != bk) fetch_q(bk);\n      quant_q();\n",
     "      const long long pr_q0 = clock64();\n"
     "      if (qbk != bk) fetch_q(bk);\n      quant_q();\n"
     "      pr_q += clock64() - pr_q0;\n"),
    ("    __syncwarp();\n    // the warp's positions of the item",
     "    __syncwarp();\n    const long long pr_s0 = clock64();\n"
     "    // the warp's positions of the item"),
    ("    __syncwarp();\n  };\n\n  if (!producer && count > 0) {",
     "    __syncwarp();\n    pr_st += clock64() - pr_s0;\n  };\n\n"
     "PROBE_BEGIN\n  if (!producer && count > 0) {"),
    ("  const RingLayout L = ring_layout(3, p.G, D);\n",
     "  const RingLayout L = ring_layout(3, p.G, D);\n"
     "  const long long pr_q = 0, pr_st = 0;\n"))


def build_probed(build) -> Path:
    """The probed library, compiled with the port's flags."""
    src = (build.CSRC / "decode_attention_q8.cu").read_text()
    for old, new in (*SCORES_PARTS, (SCORES_LOOP, SCORES_PROBED),
                     (PQ_LOOP, PQ_PROBED)):
        if src.count(old) != 1:
            raise SystemExit("decode_q8_ring_probe: a ring loop is not as "
                             "this script expects; update its anchors")
        src = src.replace(old, new)
    # the probes sit after the source's helpers, before its first kernel
    at = src.index("namespace {")
    src = src[:at] + PROBE_DEFS + src[at:] + READER
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / "decode_attention_q8_probe.cu", OUT / "libprobe.so"
    cu.write_text(src)
    res = subprocess.run([build._nvcc(), *build.flags("decode_attention_q8"),
                          "-I", str(build.CSRC), "-o", str(lib), str(cu)],
                         capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(res.stdout[-4000:] + res.stderr[-4000:])
    return lib


def summary(rows) -> dict:
    """The launch's blocks: times on the global timer (ns), and thread
    0's cycles, at the SM clock that its cycles over its block's span
    give."""
    rows = [r for r in rows if r[1] > 0]
    start = min(r[0] for r in rows)
    lengths = [r[1] - r[0] for r in rows]
    cycles = sum(sum(r[2:6]) for r in rows)
    hz = cycles / (sum(lengths) * 1e-9)
    parts = {name: sum(r[i] for r in rows) / len(rows) / hz * 1e6
             for name, i in (("wait_first", 2), ("wait", 3), ("issue", 4),
                             ("compute", 5), ("compute_q", 8),
                             ("compute_stores", 9), ("producer_issue", 10),
                             ("producer_wait", 11))}
    return {"blocks": len(rows),
            "span_us": (max(r[1] for r in rows) - start) / 1e3,
            "start_spread_us": (max(r[0] for r in rows) - start) / 1e3,
            "end_spread_us": (max(r[1] for r in rows)
                              - min(r[1] for r in rows)) / 1e3,
            "block_us_mean": sum(lengths) / len(lengths) / 1e3,
            "block_us_max": max(lengths) / 1e3,
            "items_mean": sum(r[6] for r in rows) / len(rows),
            "sms": len({r[7] for r in rows}), "sm_hz": hz,
            "thread0_us_mean": parts}


def main() -> int:
    cs = _load("chip_smoke", ROOT / "chip_smoke.py")
    m = cs._imports()
    torch, build, ops = m["torch"], m["build"], m["q8_ops"]
    if not torch.cuda.is_available():
        raise SystemExit("decode_q8_ring_probe: needs a CUDA card")
    lib = ctypes.CDLL(str(build_probed(build)))
    build._libs["decode_attention_q8"] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    B, S, KV, G, D = cs.Q8_TIMING
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 27)
    q, cache, full = cs._q8_random(torch, g, B, S, KV, G, D)
    buf = (ctypes.c_ulonglong * (4096 * SLOTS))()
    for n in (16, 1):
        c0, start = cs._q8_blocks(cache, n)[0]
        st0, mx = ops.STAGES.scores(q, c0, full, None, start, S)
        st1, l = ops.STAGES.exp(st0, mx)
        st2, pm = ops.STAGES.pv(st1, l)
        ps = torch.clamp(pm / torch.full_like(pm, 127.0), min=1e-20)
        calls = {
            0: lambda: ops.STAGES.scores(q, c0, full, None, start, S),
            1: lambda: ops.STAGES.pq(st2, ps)}
        for stage, fn in calls.items():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            lib.q8_probe_clear()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            if lib.q8_probe_read(ctypes.byref(buf), stage) != 0:
                raise SystemExit("decode_q8_ring_probe: reading the probes "
                                 "failed")
            rows = [tuple(buf[i * SLOTS:(i + 1) * SLOTS])
                    for i in range(4096)]
            rec = {"stage": ("decode_q8_scores", "decode_q8_pq")[stage],
                   "block": [B, S // n, KV, G, D],
                   "event_ms": t0.elapsed_time(t1), "card": smi}
            rec.update(summary(rows))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
