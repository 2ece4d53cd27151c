"""Parameters in and out of the port's models (no JAX twin).

``from_numpy`` loads the numpy tree of ``repro.models.api.build_params``
(the caller does the ``jax -> np.asarray`` step, so nothing here sees
JAX) into the family's model (``transformer.DecoderLM`` for dense, MoE
and the VLM backbone, ``zamba.ZambaLM`` for hybrid, ``xlstm_lm.XlstmLM``
for xlstm, ``whisper.WhisperLM`` for audio); ``to_numpy`` gives the
tree back.  The model keeps the JAX tree's paths and stacked [L, ...]
leaves (a stage of no layers has [0, ...] leaves), every weight as
``x @ W`` [d_in, d_out].

With a `mesh` (and `rules`), ``from_numpy`` places the loaded model's
leaves on it (``ParamTree.place``: DTensors, the partitioned form);
``to_numpy`` gathers a placed leaf whole (``full_tensor``).

``init_params`` is the port's own initializer.  Each leaf's init comes
from its ``params.Leaf`` in the family's spec, which mirrors the JAX
initializers (``repro/models/{common,attention,mlp,moe,ssm,zamba,
whisper,xlstm}.py``): norms and ``D`` 1, biases, ``A_log`` and
``dt_bias`` 0, the xLSTM forget-gate biases 3 (mLSTM) and 1 (sLSTM),
the embedding N(0, 0.02), every other weight N(0, 1/fan_in) with the
JAX fan-in (W for the depthwise convs).  Draws are fp32 from a
``torch.Generator``; the router, ``A_log``, ``D``, ``dt_bias`` and the
xLSTM gate weights and biases stay fp32 in a bf16 model.
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
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer, whisper, xlstm_lm, zamba
from repro_torch.models.common import dtype_of
from repro_torch.models.params import Model

FAMILIES = ("dense", "moe", "vlm", "hybrid", "xlstm", "audio")


def model_class(cfg: ModelConfig):
    """The model class of `cfg`'s family (an unknown family raises
    ``NotImplementedError``)."""
    classes = {"dense": transformer.DecoderLM, "moe": transformer.DecoderLM,
               "vlm": transformer.DecoderLM, "hybrid": zamba.ZambaLM,
               "xlstm": xlstm_lm.XlstmLM, "audio": whisper.WhisperLM}
    if cfg.family not in classes:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (the port runs "
            f"{', '.join(FAMILIES)})")
    return classes[cfg.family]


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
               dtype: Optional[torch.dtype] = None, mesh=None,
               rules: Optional[Dict[str, Any]] = None) -> Model:
    """A model holding exactly the leaves of `tree` (numpy arrays of any
    float dtype; bf16 -> fp32 -> bf16 is exact), placed on `mesh` by
    `rules` (the train rules when None) when a mesh is given."""
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
    if mesh is not None:
        model.place(mesh, rules or shd.train_rules(mesh))
    return model


def to_numpy(model: Model) -> Dict[str, Any]:
    """The nested numpy tree (fp32) of `model`, in from_numpy's layout."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        t = p.detach()
        if hasattr(t, "full_tensor"):        # a placed (DTensor) leaf
            t = t.full_tensor()
        node[leaf] = t.float().cpu().numpy()
    return tree


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator], *,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Model:
    """Random model drawn in fp32 from `generator` (which must live on
    `device`), each leaf by its spec's init.  On ``meta`` (the dry run)
    the leaves are allocated empty, nothing is drawn and `generator` is
    ignored: ``torch.Generator`` has no meta device."""
    model = _empty_model(cfg, device, dtype)
    dev = model.device
    if dev.type == "meta":
        return model
    for _name, p, leaf, n in model.leaves():
        if leaf.init == "fill":
            p.data.fill_(leaf.value)
            continue
        std = (0.02 if leaf.init == "embed"
               else 1.0 / math.sqrt(max(leaf.fan_in, 1)))
        for t in ([p.data[i] for i in range(n)] if n is not None
                  else [p.data]):
            w = torch.randn(tuple(leaf.shape), generator=generator,
                            device=dev, dtype=torch.float32)
            t.copy_(w.mul_(std))
    return model
