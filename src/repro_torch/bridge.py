"""Parameters in and out of the port's modules (no JAX twin).

``from_numpy`` loads the numpy tree of ``repro.models.api.build_params``
(the caller does the ``jax -> np.asarray`` step, so nothing here sees
JAX) into a ``DenseLM``; ``to_numpy`` gives the tree back.  The tree
keeps the JAX layout: stacked [L, ...] leaves under ``stage1``
(``norm1``, ``norm2``, ``attn/{wq,wk,wv,wo}``,
``mlp/{w_gate,w_up,w_down}``), plus ``embed``, ``final_norm`` and
``lm_head``, every weight as ``x @ W`` [d_in, d_out].

``init_params`` is the port's own initializer, with the JAX package's
scales (``repro/models/common.py`` ``dense_init``/``embed_init``/
``ones_init``) drawn from a ``torch.Generator``.  It fills one layer at
a time, so a full-width model never holds an fp32 copy of a whole
stacked leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.models.transformer import DenseLM


def _leaves(tree: Dict[str, Any], prefix: str = ""
            ) -> Iterator[Tuple[str, Any]]:
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, sub


def from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
               device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None) -> DenseLM:
    """A DenseLM holding exactly the leaves of `tree` (numpy arrays of
    any float dtype; bf16 -> fp32 -> bf16 is exact)."""
    dev = resolve_device(device)
    model = DenseLM(cfg, dtype=dtype or dtype_of(cfg.dtype), device=dev)
    want = {name for name, _ in model.named_parameters()}
    got = dict(_leaves(tree))
    if set(got) != want:
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(want - set(got))}, unexpected "
                         f"{sorted(set(got) - want)}")
    for name, arr in got.items():
        p = model.get_parameter(name)
        src = torch.from_numpy(np.array(arr, dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(p.shape)}")
        p.data.copy_(src.to(p.dtype))
    return model


def to_numpy(model: DenseLM) -> Dict[str, Any]:
    """The nested numpy tree (fp32) of `model`, in from_numpy's layout."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> DenseLM:
    """Random DenseLM: norms 1, embed N(0, 0.02), every matrix
    N(0, 1/fan_in), drawn in fp32 from `generator` (which must live on
    `device`) and cast to `dtype`."""
    dev = resolve_device(device)
    model = DenseLM(cfg, dtype=dtype or dtype_of(cfg.dtype), device=dev)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("norm") or leaf == "final_norm":
            p.data.fill_(1.0)
            continue
        if leaf.startswith("b"):             # qkv biases
            p.data.zero_()
            continue
        stacked = name.startswith("stage")
        shape = tuple(p.shape[1:]) if stacked else tuple(p.shape)
        # a weight [.., d_in, d_out] has fan-in d_in
        std = 0.02 if leaf == "embed" else 1.0 / math.sqrt(max(shape[-2], 1))
        targets = [p.data[i] for i in range(p.shape[0])] if stacked \
            else [p.data]
        for t in targets:
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            t.copy_(w.mul_(std))
    return model
