"""Token digests of a tree's ``chip_smoke.py`` serve phase.

    python experiments/serve_digests.py [--tree PATH]

Imports ``PATH/chip_smoke.py`` (default: this checkout) and through it
``repro_torch`` from ``PATH/src``, builds the kernels, runs that
script's ``serve_phase`` and prints one JSON line: for every serve path
whose result holds its tokens ("out"), the digest of those tokens by
this checkout's ``chip_smoke.token_digest``.  So a tree whose
``chip_smoke.py`` printed no digests (a parent unpacked with ``git
archive``) can be compared with the digests a later ``chip_smoke.py``
run printed, path by path, on the same card.  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    digest = _load("this_chip_smoke", ROOT / "chip_smoke.py").token_digest
    tree = _load("tree_chip_smoke", Path(args.tree).resolve()
                 / "chip_smoke.py")
    m = tree._imports()
    torch = m["torch"]
    if not torch.cuda.is_available():
        raise SystemExit("serve_digests: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    m["build"].build()
    serve = tree.serve_phase(m)
    print(json.dumps({"tree": args.tree,
                      "seconds": time.perf_counter() - t0,
                      "digests": {p: digest(v["out"])
                                  for p, v in serve.items()
                                  if isinstance(v, dict) and "out" in v}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
