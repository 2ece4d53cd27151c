"""How far each package's fp32 train-step grads are from an fp64 run.

    PYTHONPATH=src JAX_PLATFORMS=cpu python \
        experiments/train_grad_precision.py --arch zamba2-7b --layers 7
    ... --arch xlstm-125m --layers 2 --xlstm-pattern ms

One step's grads through each trainer's ``_make_accumulate`` on the
reduced config of `--arch` cut to `--layers` (and, for xlstm, its block
pattern replaced by `--xlstm-pattern`) (fp32, remat none, seq 32,
batch 4, the ``SyntheticLM`` batch of step 0, the JAX package's seed-0
weights in both): the JAX package's, the port's, and the port's again
in fp64 (its parameters in fp64; for that run every ``Tensor.float()``
and every fp32 ``torch.zeros`` of the port's model code give fp64).
Prints one JSON line: for each fp32 run, the worst max |g - g64| / max
|g64| over the grad leaves and its leaf, and the same between the two
fp32 runs (the JAX grads' largest entries as the scale); and, under
"leaves", every leaf whose fp32 grads are more than 1e-5 of its largest
entry apart: that largest entry in fp64, the three figures, and the
largest fp64 grad entry of any leaf.  CPU only;
imports both packages, as the parity tests do.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.training import loop as jtl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (ShapeConfig, TrainConfig,  # noqa: E402
                                 reduced_config)
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.training import loop as tl  # noqa: E402


def _as64(fn):
    """`fn` with an fp32 `dtype` keyword made fp64."""
    def call(*args, **kw):
        if kw.get("dtype") is torch.float32:
            kw["dtype"] = torch.float64
        return fn(*args, **kw)
    return call


@contextlib.contextmanager
def _fp64():
    """``Tensor.float()`` and fp32 ``torch.zeros``, ``torch.arange`` and
    ``Tensor.new_zeros`` give fp64 inside."""
    saved = (torch.Tensor.float, torch.zeros, torch.arange,
             torch.Tensor.new_zeros)
    torch.Tensor.float = lambda self: self.to(torch.float64)
    torch.zeros, torch.arange = _as64(saved[1]), _as64(saved[2])
    torch.Tensor.new_zeros = _as64(saved[3])
    try:
        yield
    finally:
        (torch.Tensor.float, torch.zeros, torch.arange,
         torch.Tensor.new_zeros) = saved


def _worst(got: dict, want: dict, scale: dict) -> list:
    ratio, leaf = max((float(np.abs(got[n] - want[n]).max()
                             / np.abs(scale[n]).max()), n) for n in want)
    return [ratio, leaf]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--xlstm-pattern", default=None,
                    help="xlstm block kinds, e.g. 'ms'")
    args = ap.parse_args()
    kw = dict(num_layers=args.layers, dtype="float32")
    if args.xlstm_pattern:
        kw["xlstm_pattern"] = tuple(args.xlstm_pattern)
    jcfg = jax_reduced_config(args.arch).replace(**kw)
    cfg = reduced_config(args.arch).replace(**kw)
    jtc, tc = JTrainConfig(remat="none"), TrainConfig(remat="none")
    js = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    model = bridge.from_numpy(jax.tree.map(np.asarray, js.params), cfg,
                              device="cpu")
    batch = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train")).batch(0)
    jg, _ = jtl._make_accumulate(jcfg, jtc, 1)(
        js.params, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = {n: np.asarray(a, np.float64)
          for n, a in bridge._leaves(jax.tree.map(np.asarray, jg))}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model64 = copy.deepcopy(model).double()
    acc = tl._make_accumulate(cfg, tc)
    g32, _ = acc(tl.init_train_state(cfg, tc, params=model).params, tb)
    with _fp64():
        g64, _ = acc(tl.init_train_state(cfg, tc, params=model64).params,
                     tb)
    g32 = {n: t.double().numpy() for n, t in g32.items()}
    g64 = {n: t.double().numpy() for n, t in g64.items()}
    leaves = {}
    for n in jg:
        def ratio(got, want):
            return float(np.abs(got - want).max() / np.abs(want).max())
        if ratio(g32[n], jg[n]) > 1e-5:
            leaves[n] = {"max_fp64": float(np.abs(g64[n]).max()),
                         "jax_fp32_vs_fp64": ratio(jg[n], g64[n]),
                         "port_fp32_vs_fp64": ratio(g32[n], g64[n]),
                         "port_vs_jax_fp32": ratio(g32[n], jg[n])}
    print(json.dumps({"arch": args.arch, "layers": args.layers,
                      "xlstm_pattern": args.xlstm_pattern,
                      "jax_fp32_vs_fp64": _worst(jg, g64, g64),
                      "port_fp32_vs_fp64": _worst(g32, g64, g64),
                      "port_vs_jax_fp32": _worst(g32, jg, jg),
                      "largest_fp64_grad": max(float(np.abs(a).max())
                                               for a in g64.values()),
                      "leaves": leaves}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
