"""Time the int8 decode's split form (four stage launches a position
block) of this checkout against other checkouts, on one card.

    python experiments/decode_q8_split_ab.py [ROOT ...]

Each ROOT is another checkout of the repository (e.g. a parent,
unpacked with ``git archive`` into ``build/``).  Every checkout runs in
a process of its own (two versions of ``repro_torch`` cannot share
one), in turns: this, each ROOT, then the same in reverse.  Each run
builds its checkout's ``decode_attention_q8`` library, then, at
``chip_smoke.Q8_TIMING`` ([16,32768,8,G 5,128]: qwen2.5-32b's
decode_32k over 16 slots), bf16 q over full int8 caches of random
payload and scales from ``chip_smoke.kv_q8_split``'s seed, full lens,
in 1 and 16 position blocks (the whole cache; one of 16 ranks' blocks),
prints one JSON line with

- ``ptxas``: the registers and spills of the library's kernels;
- ``call_ms``: device ms of a split call (CUDA-graph replays, the
  exchanges between stages included);
- ``launch_ms``: device ms a launch of each kernel whose name starts
  with ``q8_``, under ``torch.profiler`` (by name and template
  arguments);
- ``alone_ms``: each stage alone on the first block, fed the states and
  statistics of the stages before it, CUDA-graph replays: ``warm``
  right after itself, ``cold`` after a write of 128 MB that evicts the
  50 MB L2 (the write's own time subtracted);
- ``one_launch_ms``: the one-launch kernel over the whole cache.

It also saves its outputs, and the first run's are compared with every
other's at the end (``same_bits``).  Needs a card.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = (1, 16)
FLUSH_BYTES = 128 << 20


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _alone(torch, cs, ops, q, block, lens, smax, flush) -> dict:
    """Each stage alone on one block: warm and after an L2 flush."""
    cache, start = block
    st0, m = ops.STAGES.scores(q, cache, lens, None, start, smax)
    st1, l = ops.STAGES.exp(st0, m)
    st2, pm = ops.STAGES.pv(st1, l)
    ps = torch.clamp(pm / torch.full_like(pm, 127.0), min=1e-20)
    calls = {
        "scores": lambda: ops.STAGES.scores(q, cache, lens, None, start,
                                            smax),
        "exp": lambda: ops.STAGES.exp(st0, m),
        "pv": lambda: ops.STAGES.pv(st1, l),
        "pq": lambda: ops.STAGES.pq(st2, ps)}
    flush_ms = cs._device_ms(torch, flush.zero_, reps=10, inner=5)
    out = {"flush_ms": flush_ms}
    for name, fn in calls.items():
        warm = cs._device_ms(torch, fn, reps=10, inner=10)
        cold = cs._device_ms(torch, lambda f=fn: (flush.zero_(), f()),
                             reps=10, inner=5) - flush_ms
        out[name] = {"warm": warm, "cold": cold}
    return out


def one(out_dir: Path) -> int:
    """Time this process's checkout (``ROOT`` of the script it loads:
    the working directory's)."""
    cs = _load("chip_smoke", Path.cwd() / "chip_smoke.py")
    m = cs._imports()
    torch, build, ops = m["torch"], m["build"], m["q8_ops"]
    if not torch.cuda.is_available():
        raise SystemExit("decode_q8_split_ab: needs a CUDA card")
    report = build.build(["decode_attention_q8"])["decode_attention_q8"]
    B, S, KV, G, D = cs.Q8_TIMING
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 27)
    q, cache, full = cs._q8_random(torch, g, B, S, KV, G, D)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rec = {"root": str(Path.cwd()), "shape": [B, S, KV, G, D],
           "ptxas": cs.ptxas_usage(report, r"q8_"), "blocks": {}}
    saved = {}
    for n in BLOCKS:
        parts = cs._q8_blocks(cache, n)

        def call():
            return ops.decode_attention_q8_blocks(q, parts, full, smax=S)
        saved[f"split{n}"] = call()
        r = {"block": [B, S // n, KV, G, D],
             "call_ms": cs._device_ms(torch, call, reps=10, inner=5),
             "launch_ms": cs._launch_ms(torch, call, "q8_"),
             "alone_ms": _alone(torch, cs, ops, q, parts[0], full, S,
                                flush)}
        rec["blocks"][n] = r
        del parts
        torch.cuda.empty_cache()
    saved["one"] = ops.decode_attention_q8_cuda(q, cache, full)
    rec["one_launch_ms"] = cs._device_ms(
        torch, lambda: ops.decode_attention_q8_cuda(q, cache, full))
    torch.save({k: v.cpu() for k, v in saved.items()},
               out_dir / f"{os.getpid()}.pt")
    rec["saved"] = f"{os.getpid()}.pt"
    print(json.dumps(rec), flush=True)
    return 0


def once(n: int) -> int:
    """One split call in `n` blocks and nothing else (for a profiler
    that replays every launch)."""
    cs = _load("chip_smoke", Path.cwd() / "chip_smoke.py")
    m = cs._imports()
    torch, ops = m["torch"], m["q8_ops"]
    B, S, KV, G, D = cs.Q8_TIMING
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 27)
    q, cache, full = cs._q8_random(torch, g, B, S, KV, G, D)
    ops.decode_attention_q8_blocks(q, cs._q8_blocks(cache, n), full, smax=S)
    torch.cuda.synchronize()
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        return one(Path(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--once":
        return once(int(sys.argv[2]))
    roots = [ROOT] + [Path(r).resolve() for r in sys.argv[1:]]
    order = roots + list(reversed(roots))
    saved = []
    with tempfile.TemporaryDirectory() as tmp:
        for root in order:
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one", tmp],
                cwd=root, capture_output=True, text=True)
            sys.stderr.write(res.stderr[-4000:])
            if res.returncode != 0:
                print(json.dumps({"root": str(root),
                                  "rc": res.returncode}), flush=True)
                return res.returncode
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            saved.append((str(root), json.loads(line)["saved"]))
        import torch
        first = torch.load(Path(tmp) / saved[0][1])
        for root, name in saved[1:]:
            other = torch.load(Path(tmp) / name)
            print(json.dumps({"same_bits": {
                "root": root, **{k: torch.equal(first[k], other[k])
                                 for k in first}}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
