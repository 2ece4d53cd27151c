"""Mixed-precision AdamW with fp32 master weights: the twin of
``repro.training.optimizer``, on the port's models.

State (``OptState``): ``master``, ``m``, ``v`` map each parameter name
(``Model.named_parameters``) to an fp32 tensor of its shape, and
``step`` is an int32 scalar on the model's device.  The update runs in
fp32 against the master copy, line for line as ``adamw_update`` does,
and writes the rounded result back into the parameter's storage IN
PLACE (JAX returns new arrays); ``master``, ``m`` and ``v`` are updated
in place too, one slice of at most ``CHUNK`` elements at a time, so the
temporaries stay small at full width, and so is ``step``: every holder
of the state sees the whole of it after each update.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import Model

CHUNK = 1 << 24      # elements per in-place update slice

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    master: Tree
    m: Tree
    v: Tree
    step: torch.Tensor


def init_opt_state(params: Model) -> OptState:
    """fp32 master copies (never aliasing an fp32 parameter), zero m
    and v, step 0."""
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in params.named_parameters()}
    return OptState(master=master,
                    m={n: torch.zeros_like(t) for n, t in master.items()},
                    v={n: torch.zeros_like(t) for n, t in master.items()},
                    step=torch.zeros((), dtype=torch.int32,
                                     device=params.device))


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% (fp32)."""
    warm = torch.clamp((step / max(tc.warmup_steps, 1)).float(), max=1.0)
    prog = torch.clamp(((step - tc.warmup_steps)
                        / max(tc.total_steps - tc.warmup_steps, 1)).float(),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def slices(*ts: torch.Tensor):
    """Matching flat slices of contiguous tensors of one size."""
    flat = [t.view(-1) for t in ts]
    for i in range(0, flat[0].numel(), CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


@torch.no_grad()
def adamw_update(params: Model, grads: Tree, opt: OptState,
                 tc: TrainConfig, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  grads are fp32 (accumulated); `gnorm`
    is their global norm when the caller has it.  Returns the state (the
    same tensors, step advanced by one) and metrics."""
    step = opt.step + 1
    lr = lr_schedule(step, tc)
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = (torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
            if tc.grad_clip else torch.ones((), device=gnorm.device))
    b1, b2 = tc.beta1, tc.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for name, p in params.named_parameters():
        # decoupled weight decay on matrices only (ndim >= 2), standard
        wd = tc.weight_decay if p.dim() >= 2 else 0.0
        for g, mast, m, v, out in slices(grads[name], opt.master[name],
                                          opt.m[name], opt.v[name], p.data):
            g = g.float() * clip
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            mhat = m / bc1
            vhat = v / bc2
            mast.copy_(mast - lr * (mhat / (torch.sqrt(vhat) + tc.eps)
                                    + wd * mast))
            out.copy_(mast)
    opt.step.copy_(step)
    return opt, {"lr": lr, "grad_norm": gnorm}
