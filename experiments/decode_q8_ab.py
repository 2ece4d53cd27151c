"""Time the int8 decode-attention kernel against other versions of its
source, in one process on one card.

    python experiments/decode_q8_ab.py [SOURCE ...]

Builds this checkout's ``decode_attention_q8`` library and each SOURCE
(another ``decode_attention_q8.cu``, e.g. a parent's, unpacked with
``git archive``) with the same flags.  A SOURCE that exports
``decode_attention_q8_workspace`` is called as the four-launch kernel
over a scratch buffer was (its C interface before the one-launch
design); any other with this checkout's interface and ``ops.plan``.
Then, at ``chip_smoke.Q8_TIMING`` ([16,32768,8,G 5,128]: qwen2.5-32b's
decode_32k layer over 16 slots), bf16 q over full int8 caches of random
payload and scales from ``chip_smoke.kv_q8_timing``'s seed, and at each
``chip_smoke.Q8_MODELS`` path's shape (one slot, 72 positions, all
attended), it prints

- each SOURCE's ptxas registers and spills;
- this checkout's kernel against its plain version
  (``chip_smoke._q8_compare``) at the timing shape, and each SOURCE's
  output against this checkout's (bits equal, max |diff| over max
  |out|);
- device ms per call from CUDA-graph replays, in turns: every version
  in order and then in reverse, at every shape;
- each version's device ms per launch under ``torch.profiler`` at the
  timing shape.

Needs a card.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _other(torch, cs, build, ops, path: Path, i: int):
    """A callable fn(q, cache, lens) -> out over SOURCE `path`, and its
    ptxas usage."""
    lib_path = build.BUILD_DIR / f"libdecode_q8_ab{i}.so"
    res = subprocess.run([build._nvcc(), *build.flags(
        "decode_attention_q8"), "-o", str(lib_path), str(path)],
        capture_output=True, text=True, check=True)
    usage = cs.ptxas_usage(res.stdout + res.stderr)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.decode_attention_q8
    fn.restype = ctypes.c_int
    four = hasattr(lib, "decode_attention_q8_workspace")
    if four:
        size = lib.decode_attention_q8_workspace
        size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_size_t
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I] + [P] * 9 + [I] * 6 + [ctypes.c_float, P]
    else:
        fn.argtypes = ops._ARGTYPES

    def run(q, cache, lens):
        B, _, Hq, D = q.shape
        S, KV = cache["k"].shape[1:3]
        G = Hq // KV
        out = torch.empty_like(q)
        args = [q.data_ptr(), 1, cache["k"].data_ptr(),
                cache["v"].data_ptr(), cache["k_scale"].data_ptr(),
                cache["v_scale"].data_ptr(), lens.data_ptr(),
                out.data_ptr()]
        if four:
            ws = torch.empty(size(B, KV, G, S, D), dtype=torch.uint8,
                             device="cuda")
            args += [ws.data_ptr(), None, None, B, S, KV, G, D, 0,
                     1.0 / D ** 0.5]
        else:
            pl = ops.plan(B, S, KV, G, D)
            scratch = None if pl.on_chip else torch.empty(
                pl.scratch_bytes // 4, device="cuda")
            args += [None if scratch is None else scratch.data_ptr(), None,
                     None, B, S, KV, G, D, 0, 1.0 / D ** 0.5,
                     int(pl.on_chip), pl.cluster, pl.block_positions,
                     pl.smem_bytes]
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(err, str(path))
        return out
    return run, usage


def main() -> int:
    cs = _load("chip_smoke", ROOT / "chip_smoke.py")
    m = cs._imports()
    torch, build, ops = m["torch"], m["build"], m["q8_ops"]
    if not torch.cuda.is_available():
        raise SystemExit("decode_q8_ab: needs a CUDA card")
    report = build.build(["decode_attention_q8"])["decode_attention_q8"]
    print(json.dumps({"this": cs.ptxas_usage(report)}), flush=True)
    fns = {"this": lambda q, cache, lens: ops.decode_attention_q8_cuda(
        q, cache, lens)}
    for i, path in enumerate(sys.argv[1:]):
        fns[path], usage = _other(torch, cs, build, ops, Path(path), i)
        print(json.dumps({path: usage}), flush=True)
    shapes = {"timing": cs.Q8_TIMING}
    for arch, _ in cs.Q8_MODELS:
        cfg = m["get_config"](arch)
        KV = cfg.num_kv_heads
        shapes[f"{arch} path"] = (1, cs.Q8_PROMPT + cs.Q8_NEW, KV,
                                  cfg.num_heads // KV, cfg.resolved_head_dim)
    order = list(fns) + list(reversed(list(fns)))
    for name, shape in shapes.items():
        q, cache, lens = cs._q8_random(
            torch, torch.Generator(device="cuda").manual_seed(cs.SEED + 26),
            *shape)
        want = fns["this"](q, cache, lens)
        rec = {"shape": list(shape),
               "plan": ops.plan(*shape)._asdict()}
        if name == "timing":
            chk = cs._q8_compare(m, q, cache, lens, None,
                                 "decode_attention_q8")
            chk.pop("pq")
            rec["check"] = chk
        rec["vs_this"] = {}
        for other, fn in fns.items():
            got = fn(q, cache, lens)
            rec["vs_this"][other] = {
                "same_bits": torch.equal(got, want),
                "max_diff": float((got.float() - want.float()).abs().max()
                                  / want.float().abs().max())}
        rec["device_ms"] = [
            [v, cs._device_ms(torch, lambda f=fns[v]: f(q, cache, lens))]
            for v in order]
        if name == "timing":
            rec["launch_ms"] = {
                v: cs._launch_ms(torch, lambda f=fn: f(q, cache, lens), "q8_")
                for v, fn in fns.items()}
        print(json.dumps({name: rec}), flush=True)
        del q, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
