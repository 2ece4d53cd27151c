"""Phase clocks of the SSD backward's keys pass, one tree a run.

    python experiments/ssd_bwd_phases.py [--tree PATH]

Copies ``PATH/src/repro_torch`` into ``build/ssd_bwd_phases/`` (listed
in ``.gitignore``), inserts ``clock64()`` reads at the phase borders of
``ssd_bwd_keys_kernel`` in ``csrc/ssm_scan_bwd.cu`` and a store of each
block's sums behind the scratch, builds that copy and runs it at
zamba2-7b's train shape [1,16,256,112,64,64] (fp32, seeded inputs).
The phases of a block: ``head`` (a head's start: its planes, its dS
terms and w), ``step_wait`` (a step's wait for its dy tile and the
barrier), ``dM`` (dy xdt^T's product and the loads issued before it),
``elem`` (M, dM o L, dM o M, M's planes, the rowsums), ``bar2`` (the
barrier after M's planes), ``dxdt`` (dy^T M's product and the dCB
update), ``end`` (a head's end).  It prints one JSON line: each
phase's share of all blocks' clocks, a block's mean clocks by key
tile, and the clocks of its heads' starts.  The clocks are thread 0's;
the other warps meet it at the same barriers.  The instrumented
kernel's outputs are not checked.  Needs a card; fails where the
kernel's text no longer has the places it instruments.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (1, 16, 256, 112, 64, 64)  # B, nc, Q, H, P, N
PHASES = ("head", "step_wait", "dM", "elem", "bar2", "dxdt", "end",
          "total")
TICK = ("#define TICK(i) do { const long long n_ = clock64(); "
        "T[i] += n_ - c; c = n_; } while (0)\n")
# (text of the keys kernel, what it becomes): each must occur once
EDITS = (
    ("  l.total = l.wsum + (size_t)BC * l.nq * H * 2;\n",
     "  l.total = l.wsum + (size_t)BC * l.nq * H * 2;\n"
     "  l.total += 16 * (size_t)l.nq * BC * l.groups + 4;\n"),
    ("  issue_dy<NP>(ring, a, bc, h0, kt);\n",
     "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long c0 = clock64(), c = c0;\n" + TICK +
     "  issue_dy<NP>(ring, a, bc, h0, kt);\n"),
    ("    // the walk over the query tiles at or below the keys' diagonal\n",
     "    TICK(0);\n"),
    ("      __syncthreads();  // this tile landed; the step before is done\n",
     "      __syncthreads();\n      TICK(1);\n"),
    ("      float rs[2] = {0.f, 0.f};\n",
     "      TICK(2);\n      float rs[2] = {0.f, 0.f};\n"),
    ("      fence_async();\n      __syncthreads();  // M's planes written\n",
     "      fence_async();\n      TICK(3);\n      __syncthreads();\n"
     "      TICK(4);\n"),
    ("                frag_store(dm, dst);\n              }\n            });\n"
     "    }\n",
     "                frag_store(dm, dst);\n              }\n            });\n"
     "      TICK(5);\n    }\n"),
    ("  }\n}\n\nconstexpr int kDcumItems",
     "    TICK(6);\n  }\n  T[7] = clock64() - c0;\n  if (tid == 0) {\n"
     "    long long* out = reinterpret_cast<long long*>("
     "(reinterpret_cast<uintptr_t>(a.wsum + (size_t)a.BC * nq * H * 2)"
     " + 15) & ~(uintptr_t)15);\n"
     "    for (int i = 0; i < 8; ++i) out[8 * blockIdx.x + i] = T[i];\n"
     "  }\n}\n\nconstexpr int kDcumItems"),
)


def instrument(src: Path, dst: Path) -> str:
    """Copies the package to `dst` with the keys kernel instrumented;
    returns the kernel source's text."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src / "src" / "repro_torch", dst / "src" / "repro_torch")
    path = dst / "src" / "repro_torch" / "csrc" / "ssm_scan_bwd.cu"
    text = path.read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"ssm_scan_bwd.cu: no single place {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return text


def groups(text: str, BC: int, Q: int, H: int) -> int:
    """The keys kernel's head groups, as its ``layout`` makes them."""
    most = int(re.search(r"kHeadsMax = (\d+)", text).group(1))
    slots = int(re.search(r"kSlots = (\d+)", text).group(1))
    nq = -(-Q // 64)
    hg = min(max(1, nq * BC * H // slots), most, H)
    hg = -(-H // -(-H // hg))
    return -(-H // hg)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    copy = ROOT / "build" / "ssd_bwd_phases"
    text = instrument(Path(args.tree).resolve(), copy)
    sys.path.insert(0, str(copy / "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import ops
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: needs a CUDA card", file=sys.stderr)
        return 2
    B, nc, Q, H, P, N = SHAPE
    g = torch.Generator(device="cuda").manual_seed(8)
    cum = torch.cumsum(-0.1 * torch.rand(B, nc, Q, H, generator=g,
                                         device="cuda"), dim=2)
    ins = [cum] + [torch.randn(*s, generator=g, device="cuda") for s in (
        (B, nc, Q, H, P), (B, nc, Q, N), (B, nc, Q, N), (B, nc, Q, H, P),
        (B, nc, H, N, P))]
    n = ops.bwd_workspace(B * nc, Q, H, N, P)
    ws = torch.zeros(n, dtype=torch.float32, device="cuda")
    outs = [torch.empty_like(t) for t in ins[:4]]
    fn = build.function("ssm_scan_bwd", "ssd_intra_bwd", ops._BWD_ARGTYPES)
    for _ in range(3):
        err = fn(*(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
                 ws.data_ptr(), B * nc, Q, H, N, P,
                 torch.cuda.current_stream().cuda_stream)
        build.check(err, "ssd_intra_bwd")
    torch.cuda.synchronize()
    nq, per = -(-Q // 64), B * nc * groups(text, B * nc, Q, H)
    blocks = nq * per
    end = ws.data_ptr() + 4 * (n - 16 * blocks - 4)
    off = ((end + 15) & ~15) - ws.data_ptr()
    raw = (ws.view(torch.uint8)[off:off + 64 * blocks].view(torch.int64)
           .view(blocks, 8).cpu().double())
    tot = raw.sum(0).tolist()
    print(json.dumps({
        "tree": args.tree, "shape": list(SHAPE), "blocks": blocks,
        "share": {k: v / tot[7] for k, v in zip(PHASES, tot)},
        "block_clocks_by_kt": [float(raw[i * per:(i + 1) * per, 7].mean())
                               for i in range(nq)],
        "head_start_clocks_by_kt": [
            float(raw[i * per:(i + 1) * per, 0].mean()) for i in range(nq)],
        "max_block_clocks": float(raw[:, 7].max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
