"""Parameters in and out of the port's models (no JAX twin).

``from_numpy`` loads the numpy tree of ``repro.models.api.build_params``
(the caller does the ``jax -> np.asarray`` step, so nothing here sees
JAX) into the family's model (``transformer.DecoderLM`` for dense and
MoE, ``zamba.ZambaLM`` for hybrid); ``to_numpy`` gives the tree back.
The model keeps the JAX tree's paths and stacked [L, ...] leaves, every
weight as ``x @ W`` [d_in, d_out].

``init_params`` is the port's own initializer.  Each leaf's init comes
from its ``params.Leaf`` in the family's spec, which mirrors the JAX
initializers (``repro/models/{common,attention,mlp,moe,ssm,zamba}.py``):
norms and ``D`` 1, biases, ``A_log`` and ``dt_bias`` 0, the embedding
N(0, 0.02), every other weight N(0, 1/fan_in) with the JAX fan-in (W
for the depthwise convs).  Draws are fp32 from a ``torch.Generator``;
the router, ``A_log``, ``D`` and ``dt_bias`` stay fp32 in a bf16 model.
A stacked leaf is filled one layer at a time, so a full-width model
never holds an fp32 copy of a whole stack.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer, zamba
from repro_torch.models.common import dtype_of
from repro_torch.models.params import Model

FAMILIES = ("dense", "moe", "hybrid")


def model_class(cfg: ModelConfig):
    """The model class of `cfg`'s family; the families not ported yet
    raise ``NotImplementedError``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port runs "
            f"{', '.join(FAMILIES)}; xlstm, audio and vlm come with later "
            "slices)")
    return zamba.ZambaLM if cfg.family == "hybrid" else transformer.DecoderLM


def _leaves(tree: Dict[str, Any], prefix: str = ""
            ) -> Iterator[Tuple[str, Any]]:
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, sub


def _empty_model(cfg: ModelConfig, device: DeviceLike,
                 dtype: Optional[torch.dtype]) -> Model:
    return model_class(cfg)(cfg, dtype=dtype or dtype_of(cfg.dtype),
                            device=resolve_device(device))


def from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
               device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None) -> Model:
    """A model holding exactly the leaves of `tree` (numpy arrays of any
    float dtype; bf16 -> fp32 -> bf16 is exact)."""
    model = _empty_model(cfg, device, dtype)
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


def to_numpy(model: Model) -> Dict[str, Any]:
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
                dtype: Optional[torch.dtype] = None) -> Model:
    """Random model drawn in fp32 from `generator` (which must live on
    `device`), each leaf by its spec's init."""
    model = _empty_model(cfg, device, dtype)
    dev = model.device
    for _name, p, leaf, n in model.leaves():
        if leaf.init in ("ones", "zeros"):
            p.data.fill_(1.0 if leaf.init == "ones" else 0.0)
            continue
        std = (0.02 if leaf.init == "embed"
               else 1.0 / math.sqrt(max(leaf.fan_in, 1)))
        for t in ([p.data[i] for i in range(n)] if n else [p.data]):
            w = torch.randn(tuple(leaf.shape), generator=generator,
                            device=dev, dtype=torch.float32)
            t.copy_(w.mul_(std))
    return model
