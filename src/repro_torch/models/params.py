"""Parameter trees: the port's stand-in for the JAX package's param
pytrees (no single JAX twin; each family's ``init_*`` functions in
``repro/models/{common,attention,mlp,moe,ssm,transformer,zamba}.py``
become a *spec* of ``Leaf``s here).

A spec is a nested dict whose leaves are ``Leaf``s and whose stacked
sub-trees are ``Stack``s; ``ParamTree`` turns it into an ``nn.Module``
whose parameter names are the JAX tree's paths joined by dots
(``stage1.moe.shared.w_gate``), with the stacked [n, ...] leading axis
that ``jax.vmap``-ed init gives.  Each ``Leaf`` carries its init (the
JAX initializer and fan-in) and whether it stays fp32 in a bf16 model,
so the bridge needs no name heuristics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: `shape` (per layer, for a stacked leaf), `init`
    one of 'normal' (N(0, 1/fan_in), ``dense_init``), 'embed'
    (N(0, 0.02)), 'ones', 'zeros'; `fp32` keeps it fp32 in a bf16
    model (the router, ``A_log``, ``D``, ``dt_bias``)."""
    shape: Tuple[int, ...]
    init: str = "normal"
    fan_in: int = 0
    fp32: bool = False


@dataclasses.dataclass(frozen=True)
class Stack:
    """`n` layers of `spec`, each leaf with a leading [n] axis."""
    n: int
    spec: Mapping[str, Any]


Spec = Mapping[str, Union[Leaf, Stack, Mapping[str, Any]]]


def dense(*shape: int, fan_in: int) -> Leaf:
    return Leaf(tuple(shape), "normal", fan_in)


def ones(*shape: int, fp32: bool = False) -> Leaf:
    return Leaf(tuple(shape), "ones", fp32=fp32)


def zeros(*shape: int, fp32: bool = False) -> Leaf:
    return Leaf(tuple(shape), "zeros", fp32=fp32)


def mlp_spec(d: int, f: int) -> Dict[str, Leaf]:
    """``repro.models.mlp.init_mlp``."""
    return {"w_gate": dense(d, f, fan_in=d), "w_up": dense(d, f, fan_in=d),
            "w_down": dense(f, d, fan_in=f)}


class ParamTree(nn.Module):
    """A nested dict of parameters built from a spec.  ``tree[name]``
    gives a parameter or a sub-tree; ``layer(i)`` gives layer i of a
    stacked tree as a plain nested dict of views."""

    def __init__(self, spec: Spec, *, dtype: torch.dtype,
                 device: torch.device, n: int = 0):
        super().__init__()
        self.n = n
        self.specs: Dict[str, Leaf] = {}
        for name, sub in spec.items():
            if isinstance(sub, Stack):
                if n:
                    raise ValueError(f"{name}: a Stack inside a Stack")
                self.add_module(name, ParamTree(sub.spec, dtype=dtype,
                                                device=device, n=sub.n))
            elif isinstance(sub, Leaf):
                shape = ((n,) if n else ()) + tuple(sub.shape)
                dt = torch.float32 if sub.fp32 else dtype
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dt, device=device),
                    requires_grad=False))
                self.specs[name] = sub
            else:
                self.add_module(name, ParamTree(sub, dtype=dtype,
                                                device=device, n=n))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self.specs or name in self._modules

    def layer(self, i: int) -> Dict[str, Any]:
        """Layer i of this stacked tree: {name: view or nested dict}."""
        out: Dict[str, Any] = {name: getattr(self, name)[i]
                               for name in self.specs}
        for name, mod in self._modules.items():
            out[name] = mod.layer(i)
        return out

    def leaves(self, prefix: str = ""
               ) -> Iterator[Tuple[str, nn.Parameter, Leaf, int]]:
        """(dotted name, parameter, Leaf, stack depth or 0) per leaf."""
        for name, leaf in self.specs.items():
            yield prefix + name, getattr(self, name), leaf, self.n
        for name, mod in self._modules.items():
            yield from mod.leaves(prefix + name + ".")


class Model(ParamTree):
    """The root tree of one model: its config and device ride along."""

    def __init__(self, spec: Spec, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(spec, dtype=dtype, device=device)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device
