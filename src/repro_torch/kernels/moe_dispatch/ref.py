"""Plain PyTorch MoE dispatch: the sort of (token, slot) pairs by expert
with global capacity, as ``repro.models.moe.moe_forward`` computes it,
and the capacity-buffer gather, the twin of
``repro.kernels.moe_dispatch.ref.moe_gather_ref`` (take with a validity
mask)."""
from __future__ import annotations

from typing import Tuple

import torch


def moe_gather_ref(x: torch.Tensor, slot_token: torch.Tensor, E: int,
                   C: int) -> torch.Tensor:
    """x: [T, d]; slot_token: [E*C] -> [E, C, d] (invalid slots -> 0)."""
    T, d = x.shape
    st = slot_token.long()
    valid = (st >= 0) & (st < T)
    rows = torch.where(valid, st, torch.zeros_like(st))
    buf = x[rows]
    buf = torch.where(valid[:, None], buf, torch.zeros_like(buf))
    return buf.reshape(E, C, d)


def moe_dispatch_ref(eidx: torch.Tensor, x: torch.Tensor, E: int, C: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """eidx [T, k] (each token's experts), x [T, d] -> (buf [E, C, d],
    dest_tk [T*k] int32, counts [E] int32).

    A stable argsort of the flat pairs by expert gives each pair its
    position among its expert's pairs; pairs past the capacity C go to
    the drop slot E*C.  ``dest_tk[t*k + s]`` is the slot of pair (t, s)
    and ``buf`` holds the token of each filled slot, zeros elsewhere.
    """
    T, k = eidx.shape
    dev = x.device
    flat_e = eidx.reshape(T * k)
    # a scatter-add, not bincount: its size is E on meta tensors too
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[sorted_e]
    dest = torch.where(pos < C, sorted_e * C + pos,
                       torch.full_like(pos, E * C))        # E*C = drop slot
    # inverse map: the token each slot holds; dest is unique except for
    # the drop slot, which is cut off
    slot_token = torch.full((E * C + 1,), -1, dtype=torch.int32, device=dev)
    slot_token[dest] = (sort_idx // k).to(torch.int32)
    buf = moe_gather_ref(x, slot_token[:E * C], E, C)
    dest_tk = torch.empty_like(dest)
    dest_tk[sort_idx] = dest                               # (token, slot)
    return buf, dest_tk.to(torch.int32), counts.to(torch.int32)


def moe_dispatch_bwd_ref(dbuf: torch.Tensor, dest_tk: torch.Tensor, T: int,
                         k: int) -> torch.Tensor:
    """The gradient of ``moe_dispatch_ref``'s buffer in x: dbuf [E, C, d]
    and each pair's slot dest_tk [T*k] -> dx [T, d] in dbuf's dtype.

    ``dx[t] = sum of dbuf.view(E*C, d)[dest_tk[t*k + s]]`` over the
    pairs s < k that were not dropped (slot < E*C).  Each capacity slot
    holds one pair, so this is a gather per token: no scatter, no
    atomics.  The sum is taken in fp32 and rounded once to dbuf's dtype,
    adding a token's slots in ascending slot order (the order in which
    the buffer holds them, and in which autograd's scatter-add of
    ``moe_dispatch_ref`` visits them, so that in fp32 the two agree bit
    for bit); dropped pairs sort last and add nothing."""
    EC, d = dbuf.shape[0] * dbuf.shape[1], dbuf.shape[-1]
    flat = dbuf.reshape(EC, d)
    slots = torch.sort(dest_tk.long().reshape(T, k), dim=1).values
    dx = torch.zeros((T, d), dtype=torch.float32, device=dbuf.device)
    for s in range(k):
        sl = slots[:, s]
        keep = sl < EC
        rows = flat[torch.where(keep, sl, torch.zeros_like(sl))].float()
        dx = torch.where(keep[:, None], dx + rows, dx)
    return dx.to(dbuf.dtype)
