"""Training step: the twin of ``repro.training.loop`` — cross-entropy LM
loss, grad accumulation over microbatches, mixed-precision AdamW,
optional int8 gradient compression with error feedback, grad-spike
skipping and the fleet step's masked mean over pods.

PyTorch runs eagerly and the state is updated IN PLACE (the JAX step
returns a new state from a jitted, donating function): the parameters'
storage, the optimizer's master / m / v / step and the compression error
tree are written where they are.  Each microbatch's gradients come from one
``loss.backward()`` into ``.grad`` (in the parameter's dtype, as JAX's
grads are), are added in fp32 into the accumulator, and ``.grad`` is
cleared.  Every family trains through ``api.forward`` mode 'train'; on
CUDA the forward and backward of each hand-written kernel (RMSNorm,
flash, the MoE dispatch, SSD) are kernels.  As in the JAX trainer, a
VLM's loss is taken over the text positions only: the logits of the
patch positions before them are dropped.

Data parallelism (the twin of the JAX CLI's ``--mesh``): under
``sharding.axis_rules(mesh, rules)`` the step takes the rank's rows of
the global batch, its share of every microbatch
(``data.pipeline.rank_rows``), so microbatch i of the JAX program is
split across the ranks and an MoE layer routes the same tokens
(``models/moe.py`` gathers them over the batch axes).  Each rank
accumulates its gradients as above; then every leaf is summed over the
batch axes and divided by their size, before the grad norm, the skip,
int8 compression and AdamW, so every replica applies the same update.
The loss and metrics are reduced the same way.  Only the batch axes
are trained over by whole replicas: a mesh with a model axis of more
than one rank is refused for them.

The partitioned step (FSDP over the batch axes, tensor parallelism over
``model``, as GSPMD partitions the JAX step by the rules) is taken when
the state's parameters are placed (DTensors: ``ParamTree.place``,
``place_state``), under ``sharding.axis_rules`` with their mesh.  The
batch is placed by ("batch", ...) with each rank holding its share of
every microbatch (``place_batch``, ``data.pipeline.rank_rows``), so
microbatch i is the JAX program's rows [i·mb, (i+1)·mb).  The model
code issues every collective (the FSDP gathers and their gradients'
reduce-scatters, the tensor-parallel reductions); the loss over
vocab-sharded logits takes its row max and sum over ``model``
(``cross_entropy``).  A leaf whole over ``model`` but used on each
rank's heads or columns (a Mamba2 mixer's w_B, w_C, w_dt, conv_B,
conv_C, A_log, D, dt_bias) takes a gradient declared partial over the
ranks of the other heads; ``_placed_like`` reduces any gradient left
partial into its parameter's placements.  The gradients come out
placed like their parameters and summed, so nothing is all-reduced
after them: the fp32
accumulation, the global norm (over every shard, each counted once:
the same value on every rank) and AdamW run on each rank's shards.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import rank_rows
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.models.params import Model
from repro_torch.roofline import op_cost
from repro_torch.training import optimizer as opt_mod

Tree = Dict[str, torch.Tensor]

grad_all_reduces = 0     # the data-parallel step's all-reduce calls


class TrainState(NamedTuple):
    params: Model
    opt: opt_mod.OptState
    err: Optional[Tree]      # compression error feedback (None when off)


def init_train_state(cfg: ModelConfig, tc: TrainConfig, *,
                     device: DeviceLike = None,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[Model] = None) -> TrainState:
    """Random weights from `generator` (seed ``tc.seed`` on `device`
    when None), or the given `params` (e.g. ``bridge.from_numpy`` of the
    JAX tree), which then train in place."""
    if params is None:
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(tc.seed)
        params = api.build_params(cfg, generator, device=dev)
    for p in params.parameters():
        p.requires_grad_(True)
    opt = opt_mod.init_opt_state(params)
    err = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}
           if tc.grad_compression != "none" else None)
    return TrainState(params=params, opt=opt, err=err)


def is_placed(state: TrainState) -> bool:
    """True when the state's parameters are placed (the partitioned
    step)."""
    return shd.is_placed(next(state.params.parameters()))


def place_state(state: TrainState, mesh, rules) -> TrainState:
    """`state` placed on `mesh` by `rules`, in place: the parameters
    (``ParamTree.place``) and the optimizer's master, m and v like
    their parameter; the step stays a plain scalar.  Compression's
    error tree is not partitioned."""
    if state.err is not None:
        raise NotImplementedError("gradient compression is not "
                                  "partitioned")
    state.params.place(mesh, rules)
    axes = api.param_specs(state.params.cfg)
    opt = state.opt._replace(**{
        f: shd.place(getattr(state.opt, f), axes, mesh, rules)
        for f in ("master", "m", "v")})
    return TrainState(params=state.params, opt=opt, err=None)


def placed_microbatch(batch: int, microbatch: Optional[int],
                      n: int) -> int:
    """The microbatch of a partitioned step over `n` batch ranks: the
    step's own (the whole batch when it is unset or does not divide
    it), widened to the least multiple of `n` that divides the batch
    when `n` does not divide it (qwen2.5-32b's 16 rows on the 32 ranks
    of two pods: 32).  The loss and gradients are the same mean over
    the batch, taken over fewer, larger microbatches."""
    mb = microbatch
    if not mb or mb >= batch or batch % mb:
        return batch
    wide = mb * n // math.gcd(mb, n)
    return wide if batch % wide == 0 else batch


def place_batch(batch: Dict[str, torch.Tensor], mesh, rules,
                microbatch: Optional[int] = None) -> Dict[str, Any]:
    """A global batch (every rank holds it whole) placed by ("batch",
    ...): each rank's shard is its share of every microbatch
    (``rank_rows``, of ``placed_microbatch``), so a microbatch of the
    placed batch is the same rows as the JAX program's.  Leaves already
    placed stay as they are."""
    out = {}
    for k, v in batch.items():
        if shd.is_placed(v):
            out[k] = v
            continue
        pl = shd.spec_placements(shd.checked_spec(
            ("batch",) + (None,) * (v.dim() - 1), v.shape, mesh, rules),
            mesh)
        axes = [mesh.mesh_dim_names[i] for i, p in enumerate(pl)
                if isinstance(p, shd.Shard)]
        n = mesh_mod.axis_size(mesh, axes) if axes else 1
        rank = mesh_mod.axis_index(mesh, axes) if axes else 0
        mb = placed_microbatch(v.shape[0], microbatch, n)
        rows = torch.as_tensor(rank_rows(v.shape[0], mb, rank, n),
                               device=v.device)
        out[k] = shd.DTensor.from_local(v.index_select(0, rows), mesh, pl,
                                        run_check=False)
    return out


def batch_ranks(t: torch.Tensor) -> int:
    """The ranks a placed [B, ...] leaf's rows are split over."""
    return t.shape[0] // t.to_local().shape[0]


def train_state_specs(cfg: ModelConfig, tc: TrainConfig) -> TrainState:
    """Logical-axis trees mirroring ``TrainState``: the params' axes by
    parameter name (``api.param_specs``), the optimizer's, and the
    compression error's only under compression."""
    p = api.param_specs(cfg)
    return TrainState(params=p, opt=opt_mod.opt_state_specs(p),
                      err=p if tc.grad_compression != "none" else None)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of vocab-sharded logits:
    the row max and the sum of exponentials all-reduced over `group`
    (None: the vocab is whole), with ATen's arithmetic forward and
    backward, so a group of one gives its bits."""

    @staticmethod
    def forward(ctx, x, group):
        m = x.amax(dim=-1, keepdim=True)
        if group is not None:
            m = shd.all_reduce(m, "max", group)
        s = (x - m).exp().sum(dim=-1)
        if group is not None:
            s = shd.all_reduce(s, "sum", group)
        out = s.log() + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp(), None


def _cross_entropy_placed(logits, labels, vocab_size: int) -> torch.Tensor:
    """``cross_entropy`` of placed logits [B,S,Vp] (vocab over
    ``model``, rows over the batch axes): each rank's vocab columns,
    the row's log-sum-exp and gold logit reduced over the vocab shards,
    the mean over the global batch's valid labels."""
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if isinstance(p, shd.Shard) and p.dim == logits.ndim - 1]
    group = (logits.device_mesh.get_group(vocab_dims[0]) if vocab_dims
             else None)
    if len(vocab_dims) > 1:
        raise NotImplementedError("logits' vocab over several mesh dims")
    if not shd.is_placed(labels):
        raise ValueError("placed logits need placed labels")
    lf = logits.to_local().float()
    lab = labels.to_local().to(lf.device).long()
    v0, vl = shd.local_offset(logits, logits.ndim - 1), lf.shape[-1]
    if v0 + vl > vocab_size:
        col = torch.arange(v0, v0 + vl, device=lf.device)
        lf = torch.where(col < vocab_size, lf, torch.full_like(lf, -1e30))
    lse = _LogSumExp.apply(lf, group)
    idx = lab - v0
    gold = torch.gather(lf, -1, torch.clamp(idx, 0, vl - 1)[..., None])[..., 0]
    rows = [p if isinstance(p, shd.Shard) and p.dim == 0 else shd.Replicate()
            for p in logits.placements]
    if group is not None:
        gold = torch.where((idx >= 0) & (idx < vl), gold,
                           torch.zeros((), device=gold.device))
        part = list(rows)
        part[vocab_dims[0]] = shd.Partial()
        gold = shd.from_local(gold, logits, part).redistribute(
            logits.device_mesh, rows).to_local()
    nll = lse - gold
    valid = (lab >= 0).float()
    batch_sum = [shd.Partial() if isinstance(p, shd.Shard) else p
                 for p in rows]

    def total(t):
        return shd.from_local(t, logits, batch_sum).full_tensor()
    return total(torch.sum(nll * valid)) / torch.clamp(
        total(torch.sum(valid)), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean token NLL in fp32.  Padded-vocab columns are masked out;
    labels < 0 are ignored (padding positions).  Placed logits: the
    vocab-parallel form (``_cross_entropy_placed``)."""
    if shd.is_placed(logits):
        return _cross_entropy_placed(logits, labels, vocab_size)
    lf = logits.float()
    vp = lf.shape[-1]
    if vp > vocab_size:
        col = torch.arange(vp, device=lf.device)
        lf = torch.where(col < vocab_size, lf, torch.full_like(lf, -1e30))
    lse = torch.logsumexp(lf, dim=-1)
    labels = labels.to(lf.device).long()
    gold = torch.gather(lf, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    valid = (labels >= 0).float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _split_batch(batch: Dict[str, Any], n: int) -> Dict[str, Any]:
    """[B, ...] -> [n, B/n, ...] for every leaf."""
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A placed param's grad in its param's placements, its local shard
    contiguous: DTensor's backward may leave one pending (a bias added
    to rows sharded over the batch ranks gets a partial sum over them)
    or a transposed shard (whisper's tied head), and the accumulation
    reads local shards."""
    if not shd.is_placed(p):
        return g
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    if not g.to_local().is_contiguous():
        g = shd.from_local(g.to_local().contiguous(), g)
    return g


def _make_accumulate(cfg: ModelConfig, tc: TrainConfig):
    """The grad-accumulation closure shared by the single-pod and fleet
    steps: accumulate(params, batch) -> (fp32 grads by name, metrics)."""

    def grads_of(params: Model, mb: Dict[str, Any]):
        for p in params.parameters():
            p.grad = None
        logits, aux, _ = api.forward(params, mb, cfg, mode="train",
                                     remat=tc.remat)
        labels = mb["labels"]
        if cfg.family == "vlm":        # loss only over the text positions
            logits = logits[:, -labels.shape[1]:]
        ce = cross_entropy(logits, labels, cfg.vocab_size)
        loss = ce + aux
        loss.backward()
        grads = {n: _placed_like(p.grad, p) if p.grad is not None
                 else torch.zeros_like(p)
                 for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return grads, torch.stack([loss, ce, aux.float()]).detach()

    def accumulate(params: Model, batch: Dict[str, Any], n_dp: int = 1):
        """`batch` is the rank's rows of a global batch n_dp times as
        large, microbatch by microbatch; placed parameters: the placed
        global batch (``place_batch``), each microbatch the ranks'
        shares of it."""
        placed = shd.is_placed(params.embed)
        mb = tc.microbatch
        if placed:
            mesh, rules = shd.current_context()
            batch = place_batch(batch, mesh, rules, mb)
            n_dp = 1
            mb = placed_microbatch(batch["tokens"].shape[0], mb,
                                   batch_ranks(batch["tokens"]))
        B = batch["tokens"].shape[0] * n_dp
        if not mb or mb >= B or B % mb:
            grads, lv = grads_of(params, batch)
            return ({n: g.float() for n, g in grads.items()},
                    {"loss": lv[0], "ce": lv[1], "aux": lv[2]})
        if mb % n_dp:
            raise ValueError(f"microbatch {mb} does not split over "
                             f"{n_dp} data-parallel ranks")
        n_mb, mb = B // mb, mb // n_dp
        if placed:           # a microbatch: each rank's share of it
            local = {k: v.to_local() for k, v in batch.items()}
            mb = next(iter(local.values())).shape[0] // n_mb

            def micro(i):
                return {k: shd.from_local(v[i * mb:(i + 1) * mb], batch[k])
                        for k, v in local.items()}
        else:
            def micro(i):
                return {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        gacc = {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.named_parameters()}
        lacc = torch.zeros(3, device=params.device)
        # an op-cost walk may count the first microbatch n_mb times
        for i in op_cost.repeats(n_mb):
            grads, lv = grads_of(params, micro(i))
            for n, g in grads.items():
                # a slice at a time: no fp32 copy of a whole stacked leaf
                for acc, gs in opt_mod.slices(gacc[n], g):
                    acc += gs.float() / n_mb
            lacc = lacc + lv / n_mb
            del grads
        return gacc, {"loss": lacc[0], "ce": lacc[1], "aux": lacc[2]}

    return accumulate


def _apply_update(state: TrainState, grads: Tree, metrics: Dict,
                  tc: TrainConfig) -> Tuple[TrainState, Dict]:
    """Optimizer update with optional compression and grad-spike skip.

    When tc.grad_skip_threshold > 0, a step whose global grad norm is
    non-finite or above the threshold is dropped: nothing of the state
    is written (the JAX step selects the old state in-jit; here the
    host reads the norm, one sync) and `grad_skipped` is 1."""
    err = state.err
    if tc.grad_compression == "int8":
        grads, err = compression.int8_compress_decompress(grads, err)
    gnorm = opt_mod.global_norm(grads)
    if tc.grad_skip_threshold:
        ok = bool(torch.isfinite(gnorm)) and \
            float(gnorm) <= tc.grad_skip_threshold
        metrics["grad_skipped"] = torch.tensor(int(not ok),
                                               dtype=torch.int32)
        if not ok:
            metrics.update(lr=opt_mod.lr_schedule(state.opt.step + 1, tc),
                           grad_norm=gnorm)
            return state, metrics
    opt, om = opt_mod.adamw_update(state.params, grads, state.opt, tc,
                                   gnorm=gnorm)
    if err is not state.err:
        with torch.no_grad():
            for n, e in err.items():
                state.err[n].copy_(e)
    metrics.update(om)
    return TrainState(params=state.params, opt=opt, err=state.err), metrics


def _data_group():
    """(the batch axes' group, their size) of the active mesh for a
    step of whole replicas, or (None, 1) without one."""
    ctx = shd.current_context()
    if ctx is None:
        return None, 1
    mesh, rules = ctx
    if shd.mesh_tp_degree(mesh) > 1:
        raise NotImplementedError(
            "the train step is data-parallel only: a model axis of "
            f"{shd.mesh_tp_degree(mesh)} ranks is not trained over")
    axes = rules.get("batch")
    if axes is None:
        return None, 1
    return mesh_mod.axis_group(mesh, axes), mesh_mod.axis_size(mesh, axes)


def _sync(grads: Tree, metrics: Dict, group, n: int) -> None:
    """Sum every grad leaf and the loss metrics over the data-parallel
    group and divide by its size, in place."""
    global grad_all_reduces
    for g in grads.values():
        dist.all_reduce(g, group=group)
        g /= n
    lv = torch.stack([metrics["loss"], metrics["ce"], metrics["aux"]])
    dist.all_reduce(lv, group=group)
    lv /= n
    grad_all_reduces += len(grads) + 1
    metrics.update(loss=lv[0], ce=lv[1], aux=lv[2])


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    If tc.microbatch is set and divides the batch, gradients are
    accumulated over batch // microbatch backward passes (activation
    memory scales with the microbatch, not the batch).  Under a mesh
    (``sharding.axis_rules``) `batch` is the rank's rows and the
    gradients are averaged over the batch axes (module docstring).  A
    placed state runs the partitioned step on the placed (or whole)
    global batch."""
    accumulate = _make_accumulate(cfg, tc)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if is_placed(state):         # partitioned: DTensor's reductions
            if shd.current_context() is None:
                raise ValueError("a placed state trains under "
                                 "sharding.axis_rules with its mesh")
            return _apply_update(state, *accumulate(state.params, batch),
                                 tc)
        group, n = _data_group()
        grads, metrics = accumulate(state.params, batch, n)
        if group is not None:
            _sync(grads, metrics, group, n)
        return _apply_update(state, grads, metrics, tc)

    return train_step


def make_fleet_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                          n_pods: int):
    """Returns fleet_step(state, batch, healthy) -> (state, metrics).

    `batch` leaves are pod-split [n_pods, B/n_pods, ...]; `healthy` is a
    [n_pods] mask (float or bool).  Per-pod gradients (every pod's,
    as the JAX step's vmap computes them) are reduced with a masked mean
    over healthy pods; when no pod is healthy the gradients are zero."""
    accumulate = _make_accumulate(cfg, tc)

    def fleet_step(state: TrainState, batch, healthy
                   ) -> Tuple[TrainState, Dict]:
        dev = state.params.device
        h = torch.as_tensor(healthy, device=dev)
        w = h.float()
        w = w / torch.clamp(torch.sum(w), min=1.0)
        grads: Tree = {}
        metrics: Dict[str, torch.Tensor] = {}
        for pod in range(n_pods):
            g, m = accumulate(state.params,
                              {k: v[pod] for k, v in batch.items()})
            for n, t in g.items():
                grads[n] = w[pod] * t if pod == 0 else grads[n] + w[pod] * t
            for k, v in m.items():
                metrics[k] = (w[pod] * v if pod == 0
                              else metrics[k] + w[pod] * v)
            del g
        metrics["pods_healthy"] = torch.sum(h.to(torch.int32))
        return _apply_update(state, grads, metrics, tc)

    return fleet_step


# ---------------------------------------------------------------------------
# telemetry (host side, after the step)
# ---------------------------------------------------------------------------

def record_step_metrics(registry, metrics: Dict[str, Any], *,
                        tokens: int, dt: float,
                        step: Optional[int] = None) -> None:
    """Fold one train step's outputs into an obs registry.  Reading the
    values syncs with the device: call it at the logging cadence."""
    registry.gauge("train.loss").set(float(metrics["loss"]))
    registry.gauge("train.ce").set(float(metrics["ce"]))
    if "grad_norm" in metrics:
        registry.gauge("train.grad_norm").set(float(metrics["grad_norm"]))
    if "lr" in metrics:
        registry.gauge("train.lr").set(float(metrics["lr"]))
    if int(metrics.get("grad_skipped", 0)):
        registry.counter("train.grad_skips").inc()
    if "pods_healthy" in metrics:
        registry.gauge("fleet.pods_healthy").set(int(metrics["pods_healthy"]))
    registry.histogram("train.step_time_s").observe(dt)
    registry.counter("train.steps").inc()
    registry.counter("train.tokens").inc(tokens)
    registry.gauge("train.tokens_per_s").set(tokens / max(dt, 1e-9))
    if step is not None:
        registry.gauge("train.step").set(step)
