"""Int8 KV-cache decode attention wrapper: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

``decode_attention_q8(q, cache, cache_len, window=)`` takes q [B,1,Hq,D]
(bf16 or fp32), a cache of int8 ``k``, ``v`` [B,Smax,KV,D] and fp16
``k_scale``, ``v_scale`` [B,Smax,KV], and the per-slot or scalar length
including the token being decoded; it returns [B,1,Hq,D] in q's dtype,
as ``decode_attention_q8_ref`` (the twin of the JAX package's
``decode_attention_q8``).  The kernel (``csrc/decode_attention_q8.cu``)
quantizes q, forms the int32 scores, the masked softmax, the quantized
probabilities and the int32 P·V sums itself, in one launch: a
thread-block cluster a (b, kv), its blocks splitting the positions,
with the scores in shared memory.  ``plan`` picks the form, the cluster
size, the positions a block and the shared bytes from the shape; only
a cache whose scores do not fit the blocks' shared memory takes the
scratch form, and only then does the wrapper allocate more than the
output.  It takes D in ``HEAD_DIMS`` and up to ``MAX_GROUP`` query
heads a kv head, and raises on anything else.

The split form (``decode_attention_q8(..., group=, start=, smax=)``,
a context-parallel decode: the cache holds this rank's positions
[start, start + its length) of a cache of `smax`): four launches a
rank (``STAGE_NAMES``) of the same source, with the row max, the sum of
exponentials, the max |pv| and the int32 P·V sums all-reduced over
`group` between them (``ref.split_decode``).  Stages 1 and 2 run the
one launch's code on its cluster plan (``plan(..., scratch=True)``);
stages 0 and 3 (the scores and row max; pq and P·V), whose reductions
are exact in any order, run kernels of their own on persistent blocks
(``stage_plan``: a ring of tiles in shared memory, two blocks an SM).
``decode_attention_q8_blocks`` runs the same form over several
position blocks of one process (the exchange then reduces over them
too).  The guard on exact int32 sums
(``MAX_SMAX``) applies to the whole cache's `smax`.

``launches`` counts every launch of the source's kernels (the one
launch and each stage), ``stage_launches`` the stages' by name.  CUDA
tensors launch the kernels or raise; CPU and meta tensors (the dry
run) take the plain versions (``ref.PLAIN_STAGES`` in the split form).
Each call, and each stage, declares its cost to an active op-cost walk
(``roofline.op_cost.kernel``).
"""
from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.decode_q8 import ref
from repro_torch.kernels.decode_q8.ref import decode_attention_q8_ref
from repro_torch.roofline import op_cost

SOURCE = "src/repro_torch/csrc/decode_attention_q8.cu"
HEAD_DIMS = (32, 80, 96, 128)
MAX_GROUP = 8
# the int32 sums of Smax products of two int8 (|x| <= 127) stay exact
MAX_SMAX = (2 ** 31 - 1) // (127 * 127)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P, _I] + [_P] * 9 + [_I] * 6 + [ctypes.c_float]
             + [_I] * 4 + [_P])
_OCC_ARGTYPES = [_I] * 6
_STAGE_ARGTYPES = ([_I, _P, _I] + [_P] * 10 + [_I] * 8 + [ctypes.c_float]
                   + [_I] * 4 + [_P])
# the split form's launches, in order (``decode_attention_q8_stage``)
STAGE_NAMES = ("decode_q8_scores", "decode_q8_exp", "decode_q8_pv",
               "decode_q8_pq")

# the card's limits (H100): dynamic shared memory a block, and shared
# memory an SM, of which each resident block also takes 1 KB
MAX_SMEM_BLOCK = 232_448
SMEM_SM, SMEM_RESERVED = 233_472, 1_024
MAX_CLUSTER = 8            # the portable cluster size
BLOCK_POSITIONS = 512      # a cluster grows by a block for each of these
SMS = 132                  # the H100 SXM's SMs (``stage_plan``'s default)
# the ring kernels (stages 0 and 3): k items in stage 0's ring, v tiles
# in flight ahead of stage 3's P·V (csrc's kScoresRing, kPqAhead); their
# blocks (8 warps that compute, and stage 0's producer warp) are held
# to registers that let two fit an SM (csrc's __launch_bounds__)
SCORES_RING, PQ_AHEAD = 6, 3
RING_WARPS = 8
RING_BLOCKS_PER_SM = 2

launches = 0
stage_launches = {name: 0 for name in STAGE_NAMES}


class Plan(NamedTuple):
    """How the kernel runs one call: ``on_chip`` (the scores in shared
    memory) or the scratch form, ``cluster`` blocks a (b, kv), each
    taking ``block_positions`` of the Smax positions, ``smem_bytes`` of
    dynamic shared memory a block, ``blocks_per_sm`` the occupancy the
    plan aims for, and the scratch the wrapper allocates (0 on chip)."""
    on_chip: bool
    cluster: int
    block_positions: int
    smem_bytes: int
    blocks_per_sm: int
    scratch_bytes: int


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(on_chip: bool, n: int, G: int, D: int) -> int:
    """Dynamic shared memory of one block: the kernel's ``layout``."""
    np_ = _up(n, 32)
    x = 8 * 128 + 2 * 8 * 8 * 4 + _up(np_ // 8, 16) + _up(2 * np_, 16)
    y = max(4 * G * D, 4 * G * (np_ + 4) if on_chip else 0)
    return x + _up(G * (np_ + 16), 16) + _up(y, 16)


def plan(B: int, Smax: int, KV: int, G: int, D: int, *,
         scratch: bool = False) -> Plan:
    """A cluster of up to MAX_CLUSTER blocks a (b, kv), a block for each
    BLOCK_POSITIONS positions; the scores in shared memory wherever they
    fit a block (two blocks an SM where they fit so), else the scratch
    form, which the split form's stages always take (`scratch`: the
    scores cross device memory between launches)."""
    if Smax > MAX_SMAX:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_SMAX} cache positions, got {Smax}")
    cluster = min(MAX_CLUSTER, -(-Smax // BLOCK_POSITIONS))
    n = -(-Smax // cluster)
    cluster = -(-Smax // n)           # every block has positions
    for on_chip in (False,) if scratch else (True, False):
        smem = smem_bytes(on_chip, n, G, D)
        for per_sm in (2, 1):
            if smem <= min(MAX_SMEM_BLOCK, SMEM_SM // per_sm - SMEM_RESERVED):
                return Plan(on_chip, cluster, n, smem, per_sm,
                            0 if on_chip else 4 * B * KV * G * Smax)
    raise ValueError(f"decode_attention_q8: no plan fits "
                     f"{(B, Smax, KV, G, D)}")


class RingPlan(NamedTuple):
    """One ring kernel's launch on a block of Sl positions: work items
    of ``tile`` positions by ``heads`` kv heads, ``tiles`` of them along
    Sl, ``items`` in all, taken by ``grid`` persistent blocks
    (``stage_items``), each with ``smem`` dynamic shared bytes."""
    tile: int
    heads: int
    tiles: int
    items: int
    grid: int
    smem: int


class StagePlan(NamedTuple):
    """How the split form's stages 0 (``scores``) and 3 (``pq``), the
    ring kernels, run on a block of a cache of ``kv`` heads;
    ``blocks_per_sm`` the occupancy both stages' shared memory allows."""
    scores: RingPlan
    pq: RingPlan
    kv: int
    blocks_per_sm: int


def ring_tile(D: int) -> int:
    """Rows of D bytes a work item: 8 units of 32 rows by 64 columns."""
    return 128 if D > 64 else 256


def score_heads(KV: int) -> int:
    """Stage 0's kv heads an item: the largest power of 2 up to
    min(KV, 8), so that each warp's rows of an item are one head's."""
    return next(h for h in (8, 4, 2, 1) if h <= KV)


def ring_smem(stage: int, G: int, D: int) -> int:
    """Dynamic shared memory of a ring kernel's block: the kernel's
    ``ring_layout``."""
    T, row = ring_tile(D), D + 16
    if stage == 0:    # k rows, scales, len, mbarrier; the warps' scores
        return (SCORES_RING * (T * D + 4 * T + 32)
                + RING_WARPS * MAX_GROUP * (T // RING_WARPS + 4) * 4)
    return ((PQ_AHEAD + 2) * (4 * G * T + 32)
            + (PQ_AHEAD + 1) * (T * row + _up(G * (T + 16), 16))
            + _up(4 * G * D, 16))


def stage_plan(B: int, Sl: int, KV: int, G: int, D: int, *,
               sms: int = SMS) -> StagePlan:
    """The ring kernels' plan on a block of Sl positions: two blocks an
    SM where both stages' shared memory fits so (one otherwise), on
    `sms` SMs, and no more blocks than work items.  Stage 0's items are
    ``score_heads(KV)`` heads by ring_tile(D) / heads positions (the
    records' spans in address order); stage 3's one head by
    ring_tile(D) positions, on a multiple of KV blocks (a block keeps
    one kv head; KV of them read the same tiles)."""
    if D not in HEAD_DIMS or not 0 < G <= MAX_GROUP or min(B, Sl, KV) < 1:
        raise ValueError(f"decode_attention_q8 stages: no plan for "
                         f"{(B, Sl, KV, G, D)}")
    smem = (ring_smem(0, G, D), ring_smem(3, G, D))
    per_sm = next(n for n in (RING_BLOCKS_PER_SM, 1)
                  if n * (max(smem) + SMEM_RESERVED) <= SMEM_SM)
    most = per_sm * sms
    H, T = score_heads(KV), ring_tile(D)
    tiles = -(-Sl // (T // H))
    items = B * -(-KV // H) * tiles
    scores = RingPlan(T // H, H, tiles, items, min(items, most), smem[0])
    tiles = -(-Sl // T)
    items = B * KV * tiles
    pq = RingPlan(T, 1, tiles, items, max(KV, min(items, most) // KV * KV),
                  smem[1])
    return StagePlan(scores, pq, KV, per_sm)


def stage_items(pl: StagePlan, stage: int, block: int) -> list:
    """The items block `block` of stage `stage`'s grid takes, in order
    (the kernels' ``item_span`` / ``score_item`` and ``item_run`` /
    ``item_at``), each as (b, kv, tile): the heads [kv, kv + heads) of
    the positions [tile·tile_size, (tile + 1)·tile_size)."""
    rp = pl.scores if stage == 0 else pl.pq
    if stage == 0:
        groups = -(-pl.kv // rp.heads)
        lo, hi = (rp.items * i // rp.grid for i in (block, block + 1))
        return [(it // rp.tiles // groups,
                 it // rp.tiles % groups * rp.heads, it % rp.tiles)
                for it in range(lo, hi)]
    KV, runs = pl.kv, rp.grid // pl.kv
    pairs, j = rp.items // KV, block // KV
    return [(r // rp.tiles, block % KV, r % rp.tiles)
            for r in range(pairs * j // runs, pairs * (j + 1) // runs)]


def cost(q: torch.Tensor, cache: Mapping[str, torch.Tensor]
         ) -> Tuple[float, float]:
    """(flops, bytes) of one call from the shapes alone: the int8 k and
    v and their fp16 scales read over all Smax positions, q read and the
    output written once; 4·D operations a query head and position (the
    two products).  The kernel skips masked positions and v rows whose
    probability rounds to 0, which no shape shows."""
    B, _, Hq, D = q.shape
    Smax = cache["k"].shape[1]
    nbytes = op_cost.nbytes(cache["k"], cache["v"], cache["k_scale"],
                            cache["v_scale"]) + 2 * op_cost.nbytes(q)
    return 4.0 * D * Smax * Hq * B, nbytes


def _decode_attention_q8(q: torch.Tensor, cache: Mapping[str, torch.Tensor],
                         cache_len, *, window: Optional[int] = None,
                         group=None, start: int = 0,
                         smax: Optional[int] = None) -> torch.Tensor:
    """The module docstring's entry: the one launch, or with `group` the
    split form over this rank's positions.  Without `group` the cache
    is the whole one: a `start` or `smax` that says otherwise raises."""
    if group is None and (start != 0 or smax not in (None,
                                                     cache["k"].shape[1])):
        raise ValueError(f"decode_attention_q8: positions [{start}, "
                         f"{start} + {cache['k'].shape[1]}) of a cache of "
                         f"{smax} need the group that holds the rest")
    if group is not None:
        return decode_attention_q8_blocks(
            q, [(cache, start)], cache_len, window=window,
            smax=smax or cache["k"].shape[1], group=group)
    with op_cost.kernel("decode_attention_q8", lambda: cost(q, cache)):
        if q.device.type in ("cpu", "meta"):   # meta: the dry run's shapes
            return decode_attention_q8_ref(q, cache, cache_len,
                                           window=window).contiguous()
        return decode_attention_q8_cuda(q, cache, cache_len, window=window)


decode_attention_q8 = obs.instrument_kernel("decode_attention_q8",
                                            _decode_attention_q8)


def _check_device(*tensors: torch.Tensor) -> None:
    if any(t.device.type != "cuda" or t.device != tensors[0].device
           for t in tensors):
        raise ValueError("decode_attention_q8 kernel needs CUDA tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")


def _check_inputs(q, k, v, k_scale, v_scale, window) -> None:
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode_attention_q8 takes bf16 or fp32 q, got "
                        f"{q.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8 \
            or k_scale.dtype != torch.float16 \
            or v_scale.dtype != torch.float16:
        raise TypeError("decode_attention_q8 needs int8 k, v and fp16 "
                        f"scales, got {k.dtype}, {v.dtype}, {k_scale.dtype}, "
                        f"{v_scale.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 \
            or v.shape != k.shape or k_scale.shape != k.shape[:3] \
            or v_scale.shape != k.shape[:3] or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, k_scale "
                         f"{tuple(k_scale.shape)}, v_scale "
                         f"{tuple(v_scale.shape)}")
    D, G, Smax = q.shape[3], q.shape[2] // k.shape[2], k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_q8 kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if not 0 < G <= MAX_GROUP:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_GROUP} query heads a kv head, got {G}")
    if Smax > MAX_SMAX:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_SMAX} cache positions, got {Smax}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    _check_device(q, k, v, k_scale, v_scale)
    if not all(t.is_contiguous() for t in (k, v, k_scale, v_scale)) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_q8 kernel needs contiguous "
                         "caches and 16-byte aligned k and v")


def _launch(fn, device: torch.device, *args) -> int:
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def decode_attention_q8_cuda(q: torch.Tensor,
                             cache: Mapping[str, torch.Tensor], cache_len,
                             *, window: Optional[int] = None,
                             debug: bool = False):
    """The kernel.  With `debug`, also returns the int32 scores (0 where
    masked) and pq, [B,KV,G,Smax] each, for checks against the plain
    version."""
    global launches
    k, v = cache["k"], cache["v"]
    k_scale, v_scale = cache["k_scale"], cache["v_scale"]
    _check_inputs(q, k, v, k_scale, v_scale, window)
    B, _, Hq, D = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    G = Hq // KV
    q = q.contiguous()
    lens = torch.as_tensor(cache_len, device=q.device).long().expand(B)
    lens = lens.contiguous()
    pl = plan(B, Smax, KV, G, D)
    scratch = None
    if not pl.on_chip:
        scratch = torch.empty(pl.scratch_bytes // 4, dtype=torch.float32,
                              device=q.device)
    out = torch.empty_like(q)
    dbg_s = dbg_pq = None
    if debug:
        dbg_s = torch.empty((B, KV, G, Smax), dtype=torch.int32,
                            device=q.device)
        dbg_pq = torch.empty((B, KV, G, Smax), dtype=torch.int8,
                             device=q.device)
    fn = build.function("decode_attention_q8", "decode_attention_q8",
                        _ARGTYPES)
    err = _launch(fn, q.device, q.data_ptr(), int(q.dtype == torch.bfloat16),
                  k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  dbg_s.data_ptr() if debug else None,
                  dbg_pq.data_ptr() if debug else None, B, Smax, KV, G, D,
                  window or 0, 1.0 / (D ** 0.5), int(pl.on_chip), pl.cluster,
                  pl.block_positions, pl.smem_bytes)
    build.check(err, "decode_attention_q8")
    launches += 1
    if debug:
        return out, dbg_s, dbg_pq
    return out


# ---------------------------------------------------------------------------
# the split form: four stages around the exchanges of ref.split_decode
# ---------------------------------------------------------------------------

def decode_attention_q8_blocks(q: torch.Tensor, blocks: Sequence[ref.Block],
                               cache_len, *, window: Optional[int] = None,
                               smax: int, group=None, debug: bool = False):
    """The split form over this rank's position `blocks` [(cache,
    start)] of a cache of `smax` positions: the four stages on each
    block, their parts reduced over the blocks and, with `group`,
    all-reduced over it between them.  With `debug`, also the blocks'
    pq, [B,KV,G,their positions]."""
    if smax > MAX_SMAX:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_SMAX} cache positions, got {smax}")
    for cache, start in blocks:
        if start < 0 or start + cache["k"].shape[1] > smax:
            raise ValueError(f"positions [{start}, {start} + "
                             f"{cache['k'].shape[1]}) outside a cache of "
                             f"{smax}")
    lens = torch.as_tensor(cache_len, device=q.device).long()
    lens = lens.expand(q.shape[0]).contiguous()
    return ref.split_decode(STAGES, q, blocks, lens, window=window,
                            smax=smax, exchange=ref.block_exchange(group),
                            debug=debug)


def _stage_cost(stage: int, cache, q_or_stat: torch.Tensor
                ) -> Tuple[float, float]:
    """(flops, bytes) of one stage on a block: each input read once and
    each output written once, the fp32 scores [B,KV,G,Sl] in device
    memory between stages; the products 2·D operations a query head and
    position, the softmax steps 2 or 3 an entry."""
    B, Sl, KV, D = cache["k"].shape
    G = (q_or_stat.shape[2] // KV if stage == 0 else q_or_stat.shape[2])
    n, stat = B * KV * G * Sl, 4 * B * KV * G
    if stage == 0:
        return 2.0 * D * n, (op_cost.nbytes(q_or_stat, cache["k"],
                                            cache["k_scale"]) + 4 * n + stat)
    if stage == 1:
        return 2.0 * n, 8 * n + 2 * stat
    if stage == 2:
        return 3.0 * n, 8 * n + op_cost.nbytes(cache["v_scale"]) + 2 * stat
    return (2.0 * D * n + 2 * n,
            4 * n + op_cost.nbytes(cache["v"]) + stat + stat * D)


def _on_card(cache) -> bool:
    return cache["k"].device.type not in ("cpu", "meta")


def _stage_scores(q, cache, lens, window, start, smax):
    with op_cost.kernel(STAGE_NAMES[0], lambda: _stage_cost(0, cache, q)):
        if not _on_card(cache):
            return ref.PLAIN_STAGES.scores(q, cache, lens, window, start,
                                           smax)
        k, v = cache["k"], cache["v"]
        _check_inputs(q, k, v, cache["k_scale"], cache["v_scale"], window)
        B, _, Hq, D = q.shape
        Sl, KV = k.shape[1], k.shape[2]
        G = Hq // KV
        pl = plan(B, Sl, KV, G, D, scratch=True)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        q = q.contiguous()
        if q.data_ptr() % 16:     # a view: realigned for 16-byte copies
            q = q.clone()
        state = {"q": q, "cache": cache, "lens": lens,
                 "window": window or 0, "start": start, "smax": smax,
                 "plan": pl, "ring": stage_plan(B, Sl, KV, G, D, sms=sms),
                 "scratch": torch.empty(pl.scratch_bytes // 4,
                                        dtype=torch.float32,
                                        device=q.device)}
        return state, _launch_stage(0, state, None)


def _later_stage(i: int, plain):
    """Stage i (1..3) of a block, fed the exchanged statistic: its
    kernel on the card, else `plain`."""
    def run(state, stat, *debug):
        with op_cost.kernel(STAGE_NAMES[i],
                            lambda: _stage_cost(i, state["cache"], stat)):
            if not _on_card(state["cache"]):
                return plain(state, stat, *debug)
            out = _launch_stage(i, state, stat, *debug)
            return out if i == 3 else (state, out)
    return run


STAGES = ref.Stages(_stage_scores,
                    *(_later_stage(i, f) for i, f in enumerate(
                        ref.PLAIN_STAGES[1:], start=1)))


def _launch_stage(stage: int, state, stat_in: Optional[torch.Tensor],
                  debug: bool = False):
    """One launch of ``decode_attention_q8_stage``: stages 0 and 3 run
    the ring kernels (``stage_plan``), 1 and 2 the cluster kernel
    (``plan``).  Stages 0..2 return their [B,KV,G] fp32 part; stage 3
    its int32 sums [B,KV,G,D] and, with `debug`, the block's pq."""
    global launches
    q, cache = state["q"], state["cache"]
    B, _, Hq, D = q.shape
    Sl, KV = cache["k"].shape[1], cache["k"].shape[2]
    G = Hq // KV
    if stat_in is not None and (
            stat_in.dtype != torch.float32 or stat_in.device != q.device
            or tuple(stat_in.shape) != (B, KV, G)
            or not stat_in.is_contiguous()):
        raise ValueError(f"{STAGE_NAMES[stage]}: the exchanged statistic "
                         f"must be contiguous fp32 {(B, KV, G)} on "
                         f"{q.device}, got {stat_in.dtype} "
                         f"{tuple(stat_in.shape)} on {stat_in.device}")
    dev = q.device
    stat_out = out = dbg_pq = None
    if stage == 0:        # the blocks take their max into it
        stat_out = torch.full((B, KV, G), float("-inf"), dtype=torch.float32,
                              device=dev)
    elif stage < 3:
        stat_out = torch.empty((B, KV, G), dtype=torch.float32, device=dev)
    else:                 # the blocks add their sums into it
        out = torch.zeros((B, KV, G, D), dtype=torch.int32, device=dev)
        if debug:
            dbg_pq = torch.empty((B, KV, G, Sl), dtype=torch.int8,
                                 device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    k_scale = cache["k_scale"]
    cluster = block_positions = grid = 0
    if stage in (0, 3):
        rp = state["ring"].scores if stage == 0 else state["ring"].pq
        grid, smem = rp.grid, rp.smem
        if k_scale.data_ptr() % 4:    # a view at an odd fp16: realigned
            k_scale = k_scale.clone()
    else:
        pl = state["plan"]
        cluster, block_positions = pl.cluster, pl.block_positions
        smem = pl.smem_bytes
    fn = build.function("decode_attention_q8", "decode_attention_q8_stage",
                        _STAGE_ARGTYPES)
    err = _launch(fn, dev, stage, q.data_ptr(),
                  int(q.dtype == torch.bfloat16), cache["k"].data_ptr(),
                  cache["v"].data_ptr(), k_scale.data_ptr(),
                  cache["v_scale"].data_ptr(), state["lens"].data_ptr(),
                  ptr(stat_in), ptr(stat_out), ptr(out),
                  state["scratch"].data_ptr(), ptr(dbg_pq), B, Sl, KV, G, D,
                  state["start"], state["smax"], state["window"],
                  1.0 / (D ** 0.5), cluster, block_positions, grid, smem)
    build.check(err, STAGE_NAMES[stage])
    launches += 1
    stage_launches[STAGE_NAMES[stage]] += 1
    return stat_out if stage < 3 else (out, dbg_pq)


def active_clusters(pl: Plan, B: int, KV: int, D: int) -> int:
    """Clusters of the plan that fit on the card at once."""
    fn = build.function("decode_attention_q8",
                        "decode_attention_q8_active_clusters", _OCC_ARGTYPES)
    return fn(D, int(pl.on_chip), pl.cluster, pl.smem_bytes, B, KV)
