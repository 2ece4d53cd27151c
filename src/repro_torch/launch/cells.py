"""Cell builders: the twin of ``repro.launch.cells``.  One (architecture
x input shape x mesh) dry-run or check cell is a step function, its
arguments and their placements:

  train cells   -> train_step(state, batch)          (grad-accum AdamW)
  prefill cells -> prefill_step(params, batch)       (builds the KV caches)
  decode cells  -> serve_step(params, caches, token) (one new token)

The JAX cells hold ``ShapeDtypeStruct``s and lower with ``jax.jit``.
Here the arguments are tensors on ``device``: ``meta`` by default (the
dry run: shapes only, nothing allocated, weights never drawn), or a real
device, where the same builder gives a cell that runs (random weights
from seed 0).  ``in_shardings`` / ``out_shardings`` are DTensor
placements, one per mesh dim (``sharding.tree_shardings_checked``), on
any mesh: a ``DeviceMesh``, or the stand-in of
``mesh.production_mesh_shape`` for the 256- and 512-device meshes, which
no world here can build.

``Cell.cost()`` walks ``fn`` once under ``roofline.op_cost`` (a train
cell counts its first microbatch, scaled by the microbatch count).  A
partitioned cell's walk sees every collective its step issues; to a
cell of whole replicas it adds the collectives of the port's
data-parallel step: in a train cell one all-reduce of every gradient
leaf (fp32, whole) and of the loss metrics over the batch axes, as
``training/loop.py`` sums them; none in a serve cell.
``Cell.state_bytes_per_device()`` is each argument leaf's bytes divided
by the sizes of the mesh axes its placement shards, plus the outputs
that are not written into a donated argument.

A builder takes a ``ShapeConfig`` wherever the JAX one takes its name (a
name still works), so a check cell can run at a shape that fits one
card, and `cfg` in place of the arch's registered config (a reduced
one, in the tests).

Two forms (``Cell.partitioned``).  A cell on a ``DeviceMesh`` (a real
world's, or ``mesh.fake_world``'s for the 256- and 512-device meshes)
is partitioned as GSPMD partitions the JAX step, in every family: its
arguments are placed (DTensors: the parameters, the optimizer state
and the caches by the rules, an int8 decode cache's fp16 scales with
its sequence, the batch by ("batch", ...) as
``training/loop.place_batch`` lays it out), the step runs the
partitioned model code (an MoE train cell under ``seq_shard``, its
layers through the a2a dispatch where it applies, else the global
sort; a hybrid train cell under ``act_shard``, its Mamba2 mixers on
each rank's SSM heads; whisper's encoder and decoder on the dense
family's placed attention and MLP; xlstm's mLSTM projections over
``model`` and both recurrences on each rank's batch rows), and
``walk`` counts one device's share of it with the collectives it
issues (FSDP gathers, tensor-parallel reductions, the a2a's
all-to-alls, the gated norms' and the int8 decode's row statistics),
so ``collectives`` adds none.  A cell on a ``MeshShape`` runs eagerly
on tensors each rank holds whole: the rules place the state for the
count of bytes a device only, ``walk`` counts the whole step and
``collectives`` adds the all-reduce of the gradients.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard
from torch.utils import _pytree as pytree

from repro_torch.configs import (SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                                 TrainConfig, get_config)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.models.params import Model
from repro_torch.roofline import op_cost
from repro_torch.training import loop as train_loop

ShapeLike = Union[str, ShapeConfig]
# families whose train and prefill cost is a quadratic in the sequence
# length, walked at three lengths (``Cell.walk``): two or more mLSTM
# chunks of 64 each, so every length takes the same ops
SEQ_FIT = ("xlstm",)
FIT_LENGTHS = (128, 192, 256)


def partitioned(mesh) -> bool:
    """True when a cell on `mesh` runs the partitioned step: on a
    ``DeviceMesh``."""
    return isinstance(mesh, DeviceMesh)


def _struct(x: Any) -> Any:
    """`x` with each model replaced by its {name: parameter} dict (the
    tree the logical axes are keyed by)."""
    if isinstance(x, Model):
        return dict(x.named_parameters())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_struct(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_struct(v) for v in x)
    if isinstance(x, dict):
        return {k: _struct(v) for k, v in x.items()}
    return x


def _is_placements(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        hasattr(p, "is_shard") for p in x)


def leaf_bytes_per_device(t: torch.Tensor, placements, mesh) -> float:
    """A tensor's bytes on one device under `placements`: divided by the
    size of every mesh dim that shards it."""
    div = 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            div *= mesh.size(i)
    return t.numel() * t.element_size() / div


def tree_bytes_per_device(tree: Any, placements: Any, mesh) -> float:
    """Bytes on one device of every tensor of `tree` (None leaves: an
    absent state) under its placements, a tree of the same structure
    (matched key by key)."""
    total = [0.0]

    def one(pl, t):
        if isinstance(t, torch.Tensor):
            total[0] += leaf_bytes_per_device(t, pl, mesh)
    pytree.tree_map(one, placements, _struct(tree), is_leaf=_is_placements)
    return total[0]


def shard_shape(t: torch.Tensor, placements, mesh) -> Tuple[int, ...]:
    """The shape of a device's shard under `placements`."""
    shape = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(i)
    return tuple(shape)


@dataclasses.dataclass
class Cell:
    arch: str
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any                        # DeviceMesh or mesh.MeshShape
    rules: Dict[str, Any]
    fn: Callable
    args: Tuple[Any, ...]            # tensors on meta (or a real device)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any               # None where outputs() decide
    donate_argnums: Tuple[int, ...]
    static_desc: str = ""
    microbatches: int = 1            # a train step's microbatch loop
    partitioned: bool = False        # placed arguments, per-device walk

    def run(self):
        """``fn(*args)``, under the cell's mesh when it is a
        ``DeviceMesh`` (the step's data-parallel collectives included)."""
        if isinstance(self.mesh, mesh_mod.MeshShape):
            return self.fn(*self.args)
        with shd.axis_rules(self.mesh, self.rules):
            return self.fn(*self.args)

    def walk(self) -> Tuple[op_cost.StepCost, Any]:
        """(cost, outputs) of ``fn(*args)`` under an op-cost walk, its
        first microbatch scaled by the microbatch count.  A partitioned
        cell is walked on its mesh: one device's share of the step, the
        collectives it issues included.  Any other is walked with no
        mesh: the whole (global) step, the same on every mesh.

        A family in ``SEQ_FIT`` runs a train or prefill step at three
        short lengths (``FIT_LENGTHS``; a placed batch sliced on its
        sequence dim) and the cost is the quadratic through them, taken
        at the cell's length: its sLSTM's loop over tokens would
        otherwise dispatch millions of ops.  The fit is exact: every
        op's count is a polynomial of degree two or less in the length
        (a loop over tokens or chunks of ops whose sizes grow with it at
        most linearly: the backward of ``x[:, t]`` writes a zero-filled
        gradient of all of x for each t), so the prefill's is linear and
        the train step's quadratic; a partitioned cell's collectives are
        outside the loops, so their counts are constant and their bytes
        linear (``tests/test_torch_cells.py`` holds the fit to a fourth
        walk).  The outputs are the last walk's (their shapes do not
        depend on the length)."""
        with (shd.axis_rules(self.mesh, self.rules) if self.partitioned
              else contextlib.nullcontext()):
            S = self.shape.seq_len
            if (self.cfg.family not in SEQ_FIT
                    or self.shape.kind == "decode" or S <= FIT_LENGTHS[-1]):
                return op_cost.walk(self.fn, *self.args, sample_loops=True)
            costs = []
            for s in FIT_LENGTHS:
                args = list(self.args)
                args[-1] = {k: v[:, :s] for k, v in args[-1].items()}
                cost, out = op_cost.walk(self.fn, *args, sample_loops=True)
                costs.append(cost)
        weights = [math.prod((S - sj) / (si - sj) for sj in FIT_LENGTHS
                             if sj != si) for si in FIT_LENGTHS]
        return op_cost.combine(costs, weights), out

    def collectives(self, cost: op_cost.StepCost) -> None:
        """Add the collectives of the port's step on this cell's mesh to
        `cost`: in a train cell one all-reduce a gradient leaf (fp32) and
        one of the three loss metrics, over the batch axes; none in a
        partitioned cell, whose walk saw the collectives it issues."""
        if self.shape.kind != "train" or self.partitioned:
            return
        axes = self.rules.get("batch")
        n = 1 if axes is None else mesh_mod.axis_size(self.mesh, axes)
        params = self.args[0].params
        for p in params.parameters():
            s = 4 * p.numel()
            cost.add_collective("all-reduce", s, s, n)
        cost.add_collective("all-reduce", 12, 12, n)

    def cost(self, walked: Optional[Tuple[op_cost.StepCost, Any]] = None
             ) -> op_cost.StepCost:
        """The step's cost on this mesh: a walk (`walked`, when one was
        made on a cell of the same arch and shape, else a new one) plus
        ``collectives``."""
        base = (walked or self.walk())[0]
        cost = dataclasses.replace(
            base, coll_op_bytes=dict(base.coll_op_bytes),
            coll_op_counts=dict(base.coll_op_counts))
        self.collectives(cost)
        return cost

    def out_placements(self, i: int, out: Any) -> Any:
        """Placements of output i: a prefill's caches by the decode-cache
        rules (``api.cache_axes_of``), anything else replicated."""
        if self.shape.kind == "prefill" and i == 1:
            axes = api.cache_axes_of(out)
        else:
            axes = pytree.tree_map(lambda _: None, _struct(out))
        return shd.tree_shardings_checked(axes, _struct(out), self.mesh,
                                          self.rules)

    def arg_bytes_per_device(self) -> float:
        return sum(tree_bytes_per_device(a, s, self.mesh)
                   for a, s in zip(self.args, self.in_shardings))

    def state_bytes_per_device(self, outputs: Any = None) -> float:
        """The arguments' bytes a device plus the outputs' that are not
        written into a donated argument (outputs from a walk, made now
        when not given).  Temporaries are not counted: a lower bound."""
        if outputs is None:
            outputs = self.walk()[1]
        total = self.arg_bytes_per_device()
        for i, out in enumerate(outputs):
            if i not in self.donate_argnums:
                total += tree_bytes_per_device(
                    out, self.out_placements(i, out), self.mesh)
        return total


def _shape(shape: ShapeLike) -> ShapeConfig:
    return SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape


def _batch(cfg: ModelConfig, shape: ShapeConfig,
           device: torch.device) -> Dict[str, torch.Tensor]:
    if device.type == "meta":
        return {k: torch.empty(s.shape, dtype=s.dtype, device=device)
                for k, s in api.input_specs(cfg, shape).items()}
    return api.synthesize_batch(cfg, shape, device=device)


def _batch_shardings(batch, mesh, rules):
    axes = {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in batch.items()}
    return shd.tree_shardings_checked(axes, batch, mesh, rules)


def default_train_config(cfg: ModelConfig, shape: ShapeConfig,
                         **overrides) -> TrainConfig:
    """Baseline knobs: full remat + grad accumulation with microbatch 32
    (the JAX package's; per-arch overrides below)."""
    kw: Dict[str, Any] = dict(microbatch=min(32, shape.global_batch),
                              remat="full")
    kw.update(overrides)
    return TrainConfig(**kw)


# Per-arch knobs of the JAX package's train cells (implementation
# parameters, not architecture changes):
#   microbatch — grad-accum microbatch size
#   act_shard  — shard the residual stream's d_model over the model axis
#   seq_shard  — shard the sequence over the model axis
#   ssm_chunk  — SSD chunk length
ARCH_TRAIN_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "qwen2.5-32b": {"microbatch": 16},
    "internvl2-76b": {"microbatch": 32, "act_shard": True},
    "zamba2-7b": {"ssm_chunk": 64, "microbatch": 16, "act_shard": True},
    "olmoe-1b-7b": {"microbatch": 256, "seq_shard": True},
    "deepseek-moe-16b": {"microbatch": 128, "seq_shard": True},
}


_RULE_KNOBS = ("act_shard", "seq_shard", "moe_dispatch")


def arch_train_rules(arch: str, mesh) -> Dict[str, Any]:
    """The train rules of `arch`'s train cells on `mesh`, with its
    knobs: ``act_shard`` (the residual's d_model over ``model``),
    ``seq_shard`` (its sequence over ``model``: the MoE cells),
    ``moe_dispatch``."""
    over = ARCH_TRAIN_OVERRIDES.get(arch, {})
    rules = shd.train_rules(mesh)
    if over.get("act_shard"):
        rules["act_embed"] = "model"
    if over.get("seq_shard"):
        rules["seq"] = "model"
        rules["act_embed"] = None
    if over.get("moe_dispatch"):
        rules["moe_dispatch"] = over["moe_dispatch"]
    return rules


def build_train_cell(arch: str, shape: ShapeLike, mesh,
                     tc: Optional[TrainConfig] = None,
                     rules: Optional[Dict[str, Any]] = None, *,
                     device: DeviceLike = "meta",
                     cfg: Optional[ModelConfig] = None) -> Cell:
    cfg = cfg or get_config(arch)
    shape = _shape(shape)
    dev = resolve_device(device)
    over = {k: v for k, v in ARCH_TRAIN_OVERRIDES.get(arch, {}).items()
            if k not in _RULE_KNOBS}
    ssm_chunk = over.pop("ssm_chunk", None)
    if ssm_chunk and cfg.ssm.d_state:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    tc = tc or default_train_config(cfg, shape, **over)
    if rules is None:
        rules = arch_train_rules(arch, mesh)

    state = train_loop.init_train_state(cfg, tc, device=dev)
    batch = _batch(cfg, shape, dev)
    part = partitioned(mesh)
    if part:
        state = train_loop.place_state(state, mesh, rules)
        batch = train_loop.place_batch(batch, mesh, rules, tc.microbatch)
    state_shardings = shd.tree_shardings_checked(
        train_loop.train_state_specs(cfg, tc), _struct(state), mesh, rules)
    B, mb = shape.global_batch, tc.microbatch
    if part:
        mb = train_loop.placed_microbatch(
            B, mb, train_loop.batch_ranks(batch["tokens"]))
    n_mb = B // mb if mb and mb < B and B % mb == 0 else 1
    # the microbatch walked: a placed one widens to the batch ranks
    desc = f"train mb={mb if tc.microbatch else None} remat={tc.remat}"
    if tc.microbatch and mb != tc.microbatch:
        desc += f" (widened from {tc.microbatch} to the batch ranks)"
    return Cell(
        arch=arch, cfg=cfg, shape=shape, mesh=mesh, rules=rules,
        fn=train_loop.make_train_step(cfg, tc), args=(state, batch),
        in_shardings=(state_shardings,
                      _batch_shardings(batch, mesh, rules)),
        out_shardings=(state_shardings, None), donate_argnums=(0,),
        static_desc=desc,
        microbatches=n_mb, partitioned=part)


def build_prefill_cell(arch: str, shape: ShapeLike, mesh,
                       rules: Optional[Dict[str, Any]] = None, *,
                       device: DeviceLike = "meta",
                       cfg: Optional[ModelConfig] = None) -> Cell:
    cfg = cfg or get_config(arch)
    shape = _shape(shape)
    dev = resolve_device(device)
    rules = rules or shd.serve_rules(mesh, shard_batch=shape.global_batch > 1)

    def prefill_step(params, batch):
        logits, _aux, caches = api.forward(params, batch, cfg,
                                           mode="prefill", remat="none")
        return logits[:, -1, :], caches

    params = api.build_params(cfg, device=dev)
    batch = _batch(cfg, shape, dev)
    part = partitioned(mesh)
    if part:
        params.place(mesh, rules)
        batch = train_loop.place_batch(batch, mesh, rules)
    pshard = shd.tree_shardings_checked(api.param_specs(cfg),
                                        _struct(params), mesh, rules)
    return Cell(
        arch=arch, cfg=cfg, shape=shape, mesh=mesh, rules=rules,
        fn=prefill_step, args=(params, batch),
        in_shardings=(pshard, _batch_shardings(batch, mesh, rules)),
        out_shardings=None,             # the caches' come from outputs
        donate_argnums=(), static_desc="prefill", partitioned=part)


# int8 KV caches per arch for decode cells: none by default, as in the
# JAX package (a caller passes kv_quant=True)
ARCH_SERVE_OVERRIDES: Dict[str, Dict[str, Any]] = {}


def build_decode_cell(arch: str, shape: ShapeLike, mesh,
                      rules: Optional[Dict[str, Any]] = None,
                      kv_quant: Optional[bool] = None, *,
                      device: DeviceLike = "meta",
                      cfg: Optional[ModelConfig] = None) -> Cell:
    cfg = cfg or get_config(arch)
    shape = _shape(shape)
    dev = resolve_device(device)
    rules = rules or shd.serve_rules(mesh, shard_batch=shape.global_batch > 1)
    long_ctx = shape.name == "long_500k"
    if kv_quant is None:
        kv_quant = ARCH_SERVE_OVERRIDES.get(arch, {}).get("kv_quant", False)
    kv_quant = kv_quant and cfg.family in ("dense", "moe", "vlm")

    def serve_step(params, caches, tokens):
        logits, _aux, new_caches = api.forward(
            params, {"tokens": tokens}, cfg, mode="decode", caches=caches,
            remat="none", long_context=long_ctx)
        last = shd.replicate_dim(logits[:, -1], -1)    # whole vocab rows
        next_tok = torch.argmax(last[:, :cfg.vocab_size], dim=-1)
        return next_tok.to(torch.int32)[:, None], new_caches

    params = api.build_params(cfg, device=dev)
    caches = api.init_caches(cfg, shape.global_batch, shape.seq_len,
                             device=dev, long_context=long_ctx,
                             kv_quant=kv_quant)
    tokens = _batch(cfg, shape, dev)["tokens"]
    cache_axes = api.cache_logical_axes(cfg, shape, kv_quant=kv_quant)
    part = partitioned(mesh)
    if part:
        params.place(mesh, rules)
        caches = shd.place(caches, cache_axes, mesh, rules)
        tokens = train_loop.place_batch({"t": tokens}, mesh, rules)["t"]
    pshard = shd.tree_shardings_checked(api.param_specs(cfg),
                                        _struct(params), mesh, rules)
    cache_shard = shd.tree_shardings_checked(cache_axes, caches, mesh,
                                             rules)
    tok_shard = _batch_shardings({"t": tokens}, mesh, rules)["t"]
    return Cell(
        arch=arch, cfg=cfg, shape=shape, mesh=mesh, rules=rules,
        fn=serve_step, args=(params, caches, tokens),
        in_shardings=(pshard, cache_shard, tok_shard),
        out_shardings=(None, cache_shard),
        donate_argnums=(1,),
        static_desc="decode" + (" long-context" if long_ctx else "")
        + (" kv-int8" if kv_quant else ""), partitioned=part)


def build_cell(arch: str, shape: ShapeLike, mesh, **kw) -> Cell:
    kind = _shape(shape).kind
    if kind == "train":
        return build_train_cell(arch, shape, mesh, **kw)
    if kind == "prefill":
        return build_prefill_cell(arch, shape, mesh, **kw)
    return build_decode_cell(arch, shape, mesh, **kw)

