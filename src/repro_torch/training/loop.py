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
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import compression
from repro_torch.models import api
from repro_torch.models.params import Model
from repro_torch.training import optimizer as opt_mod

Tree = Dict[str, torch.Tensor]


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
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(tc.seed)
        params = api.build_params(cfg, generator, device=dev)
    for p in params.parameters():
        p.requires_grad_(True)
    opt = opt_mod.init_opt_state(params)
    err = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}
           if tc.grad_compression != "none" else None)
    return TrainState(params=params, opt=opt, err=err)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean token NLL in fp32.  Padded-vocab columns are masked out;
    labels < 0 are ignored (padding positions)."""
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
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return grads, torch.stack([loss, ce, aux.float()]).detach()

    def accumulate(params: Model, batch: Dict[str, Any]):
        B = batch["tokens"].shape[0]
        mb = tc.microbatch
        if not mb or mb >= B or B % mb:
            grads, lv = grads_of(params, batch)
            return ({n: g.float() for n, g in grads.items()},
                    {"loss": lv[0], "ce": lv[1], "aux": lv[2]})
        n_mb = B // mb
        gacc = {n: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
                for n, p in params.named_parameters()}
        lacc = torch.zeros(3, device=params.device)
        for i in range(n_mb):
            grads, lv = grads_of(params, {k: v[i * mb:(i + 1) * mb]
                                          for k, v in batch.items()})
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


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    If tc.microbatch is set and divides the batch, gradients are
    accumulated over batch // microbatch backward passes (activation
    memory scales with the microbatch, not the batch)."""
    accumulate = _make_accumulate(cfg, tc)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = accumulate(state.params, batch)
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
