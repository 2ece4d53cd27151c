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
so the bridge needs no name heuristics, and its logical axes (the JAX
package's ``*_specs`` entry for that weight), so the sharding rules
need no second tree: ``logical_axes`` gathers them by the same dotted
paths, a ``Stack`` prepending ``None`` for its layer axis.
``ParamTree.place`` turns every leaf into a DTensor with its axes'
placements on a mesh (the partitioned form of a model).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Tuple,
                    Union)

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: `shape` (per layer, for a stacked leaf), `init`
    one of 'normal' (N(0, 1/fan_in), ``dense_init``), 'embed'
    (N(0, 0.02)), 'fill' (every element `value`: norms 1, biases 0, the
    xLSTM forget-gate biases); `fp32` keeps it fp32 in a bf16 model
    (the router, ``A_log``, ``D``, ``dt_bias``, the xLSTM gates);
    `axes` one logical axis name (or None) a dim, as the JAX package's
    ``*_specs`` give them (``distributed/sharding.py`` maps them onto a
    mesh)."""
    shape: Tuple[int, ...]
    init: str = "normal"
    fan_in: int = 0
    fp32: bool = False
    value: float = 0.0
    axes: Optional[Tuple[Optional[str], ...]] = None


@dataclasses.dataclass(frozen=True)
class Stack:
    """`n` layers of `spec`, each leaf with a leading [n] axis (n may be
    0: a stage with no layers has leaves of shape [0, ...])."""
    n: int
    spec: Mapping[str, Any]


Spec = Mapping[str, Union[Leaf, Stack, Mapping[str, Any]]]


Axes = Tuple[Optional[str], ...]


def dense(*shape: int, fan_in: int, axes: Optional[Axes] = None,
          fp32: bool = False) -> Leaf:
    return Leaf(tuple(shape), "normal", fan_in, fp32=fp32, axes=axes)


def full(*shape: int, value: float, axes: Optional[Axes] = None,
         fp32: bool = False) -> Leaf:
    return Leaf(tuple(shape), "fill", fp32=fp32, value=value, axes=axes)


def ones(*shape: int, axes: Optional[Axes] = None,
         fp32: bool = False) -> Leaf:
    return full(*shape, value=1.0, axes=axes, fp32=fp32)


def zeros(*shape: int, axes: Optional[Axes] = None,
          fp32: bool = False) -> Leaf:
    return full(*shape, value=0.0, axes=axes, fp32=fp32)


def embed(vp: int, d: int) -> Leaf:
    """The embedding table [Vp, d], N(0, 0.02)."""
    return Leaf((vp, d), "embed", axes=("vocab", "embed"))


def lm_head(d: int, vp: int) -> Leaf:
    return dense(d, vp, fan_in=d, axes=("embed", "vocab"))


def norm(d: int, axis: Optional[str] = "embed") -> Leaf:
    """A norm's scale [d], all ones."""
    return ones(d, axes=(axis,))


def mlp_spec(d: int, f: int) -> Dict[str, Leaf]:
    """``repro.models.mlp.init_mlp`` (axes: ``mlp_specs``)."""
    return {"w_gate": dense(d, f, fan_in=d, axes=("embed", "mlp")),
            "w_up": dense(d, f, fan_in=d, axes=("embed", "mlp")),
            "w_down": dense(f, d, fan_in=f, axes=("mlp", "embed"))}


def logical_axes(spec: Spec, prefix: str = "") -> Dict[str, Axes]:
    """{dotted path: logical axes} of every leaf of `spec`, the paths of
    ``ParamTree``; a ``Stack``'s leaves get a leading None (their layer
    axis), as the JAX package's ``stacked`` gives them."""
    out: Dict[str, Axes] = {}
    for name, sub in spec.items():
        path = prefix + name
        if isinstance(sub, Stack):
            out.update({k: (None,) + v for k, v in
                        logical_axes(sub.spec, path + ".").items()})
        elif isinstance(sub, Leaf):
            if sub.axes is None or len(sub.axes) != len(sub.shape):
                raise ValueError(f"{path}: axes {sub.axes} for shape "
                                 f"{sub.shape}")
            out[path] = tuple(sub.axes)
        else:
            out.update(logical_axes(sub, path + "."))
    return out


class ParamTree(nn.Module):
    """A nested dict of parameters built from a spec.  ``tree[name]``
    gives a parameter or a sub-tree; ``layer(i)`` gives layer i of a
    stacked tree as a plain nested dict of views."""

    def __init__(self, spec: Spec, *, dtype: torch.dtype,
                 device: torch.device, n: Optional[int] = None):
        super().__init__()
        self.n = n          # layers of a stacked tree (maybe 0); None: not
        self.specs: Dict[str, Leaf] = {}
        for name, sub in spec.items():
            if isinstance(sub, Stack):
                if n is not None:
                    raise ValueError(f"{name}: a Stack inside a Stack")
                self.add_module(name, ParamTree(sub.spec, dtype=dtype,
                                                device=device, n=sub.n))
            elif isinstance(sub, Leaf):
                shape = ((n,) if n is not None else ()) + tuple(sub.shape)
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

    def layers(self) -> List[Dict[str, Any]]:
        """Every layer of this stacked tree, as ``layer(i)`` gives them,
        but from one ``torch.unbind`` per leaf: its backward stacks the
        layers' grads in one op, where n ``select`` backwards would each
        write a zero-filled copy of the whole stack."""
        per = {name: torch.unbind(getattr(self, name))
               for name in self.specs}
        subs = {name: mod.layers() for name, mod in self._modules.items()}
        return [{**{name: t[i] for name, t in per.items()},
                 **{name: sub[i] for name, sub in subs.items()}}
                for i in range(self.n)]

    def place(self, mesh, rules) -> "ParamTree":
        """Every leaf, in place, as a DTensor on `mesh` with the checked
        placements of its logical axes (``sharding.place_leaf``; a
        stacked leaf's layer axis stays whole).  Returns self."""
        for name, leaf in self.specs.items():
            p = getattr(self, name)
            axes = ((None,) if self.n is not None else ()) + leaf.axes
            self.register_parameter(name, nn.Parameter(
                shd.place_leaf(p.data, axes, mesh, rules),
                requires_grad=p.requires_grad))
        for mod in self._modules.values():
            mod.place(mesh, rules)
        return self

    def leaves(self, prefix: str = ""
               ) -> Iterator[Tuple[str, nn.Parameter, Leaf, Optional[int]]]:
        """(dotted name, parameter, Leaf, stack depth or None) per
        leaf."""
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
