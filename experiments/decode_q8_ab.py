"""Time the int8 decode-attention kernel against other versions of its
source, in one process on one card.

    python experiments/decode_q8_ab.py [SOURCE ...]

Builds this checkout's ``decode_attention_q8`` library and each SOURCE
(another ``decode_attention_q8.cu`` with the same C interface, e.g. a
parent's, unpacked with ``git archive``) with the same flags, then at
``chip_smoke.Q8_TIMING`` ([16,32768,8,G 5,128]: qwen2.5-32b's
decode_32k layer over 16 slots), bf16 q over full int8 caches of random
payload and scales from ``chip_smoke.kv_q8_timing``'s seed, prints

- each SOURCE's ptxas registers and spills, and whether its output
  equals this checkout's bit for bit;
- this checkout's kernel against its plain version
  (``chip_smoke._q8_compare``);
- device ms per call from CUDA-graph replays, in turns: every version
  in order and then in reverse;
- each version's device ms per launch under ``torch.profiler``.

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


def main() -> int:
    cs = _load("chip_smoke", ROOT / "chip_smoke.py")
    m = cs._imports()
    torch, build, ops = m["torch"], m["build"], m["q8_ops"]
    if not torch.cuda.is_available():
        raise SystemExit("decode_q8_ab: needs a CUDA card")
    report = build.build(["decode_attention_q8"])["decode_attention_q8"]
    print(json.dumps({"this": cs.ptxas_usage(report)}), flush=True)
    B, S, KV, G, D = cs.Q8_TIMING
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
    q = torch.randn((B, 1, KV * G, D), generator=g, device="cuda").bfloat16()
    cache = {n: torch.randint(-127, 128, (B, S, KV, D), generator=g,
                              device="cuda", dtype=torch.int8)
             for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        cache[n] = (torch.rand((B, S, KV), generator=g, device="cuda")
                    * 0.02 + 1e-3).half()
    lens = torch.full((B,), S, device="cuda")

    def this():
        return ops.decode_attention_q8_cuda(q, cache, lens)

    def other(path: Path, i: int):
        lib_path = build.BUILD_DIR / f"libdecode_q8_ab{i}.so"
        res = subprocess.run([build._nvcc(), *build.flags(
            "decode_attention_q8"), "-o", str(lib_path), str(path)],
            capture_output=True, text=True, check=True)
        usage = cs.ptxas_usage(res.stdout + res.stderr)
        lib = ctypes.CDLL(str(lib_path))
        size = lib.decode_attention_q8_workspace
        size.argtypes, size.restype = ops._WS_ARGTYPES, ctypes.c_size_t
        fn = lib.decode_attention_q8
        fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int

        def run():
            ws = torch.empty(size(B, KV, G, S, D), dtype=torch.uint8,
                             device="cuda")
            out = torch.empty_like(q)
            err = fn(q.data_ptr(), 1, cache["k"].data_ptr(),
                     cache["v"].data_ptr(), cache["k_scale"].data_ptr(),
                     cache["v_scale"].data_ptr(), lens.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), None, None, B, S, KV, G,
                     D, 0, 1.0 / D ** 0.5,
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, str(path))
            return out
        return run, usage

    fns = {"this": this}
    want = this()
    for i, path in enumerate(sys.argv[1:]):
        run, usage = other(Path(path), i)
        fns[path] = run
        print(json.dumps({path: usage, "same_bits": torch.equal(run(), want)}),
              flush=True)
    chk = cs._q8_compare(m, q, cache, lens, None, "decode_attention_q8")
    chk.pop("pq")
    order = list(fns) + list(reversed(list(fns)))
    print(json.dumps({
        "check": chk,
        "device_ms": [[name, cs._device_ms(torch, fns[name])]
                      for name in order],
        "launch_ms": {name: cs._launch_ms(torch, fn, "q8_")
                      for name, fn in fns.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
