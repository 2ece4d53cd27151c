"""Rodinia-subset kernels for the Vortex runtime (paper §V-B / Fig 9).

Each benchmark is (host-side setup -> pocl_spawn launch -> numpy oracle
check).  The set mirrors the paper's evaluation character:

  vecadd   — int streaming            (regular, memory-streaming)
  saxpy    — float streaming          (regular, Zfinx float path)
  sgemm    — tiled matmul, smem + bar (compute + shared memory + barriers)
  bfs      — level-sync BFS, bar loop (IRREGULAR: divergence + cache misses;
             the paper's showcase for warp-count benefits)
  gaussian — elimination step         (float, boundary divergence)
  nn       — nearest-neighbor dists   (float streaming)
  kmeans   — assignment step          (compute-bound, small divergence)

All return (LaunchResult, ok: bool).  The twin of
``repro.runtime.kernels_src.rodinia``: every bench takes `device`
(``cuda`` unless told ``"cpu"``) for its launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.simt.machine import MachineConfig
from repro_torch.device import DeviceLike
from repro_torch.runtime.spawn import (ARG_BASE, Allocator, LaunchResult,
                                       f32_bits, pocl_spawn, raw_spawn)


# ---------------------------------------------------------------------------
# vecadd: c[i] = a[i] + b[i]
# ---------------------------------------------------------------------------

def vecadd(mc: MachineConfig, n: int = 512, seed: int = 0,
           device: DeviceLike = None) -> Tuple[LaunchResult, bool]:
    rng = np.random.default_rng(seed)
    a = rng.integers(-1000, 1000, n).astype(np.int32)
    b = rng.integers(-1000, 1000, n).astype(np.int32)
    al = Allocator()
    pa, pb, pc = al.alloc(a), al.alloc(b), al.alloc(n)
    body = """
    slli t0, s2, 2
    lw   t1, 4(s0)       # &a
    add  t1, t1, t0
    lw   t2, 0(t1)
    lw   t3, 8(s0)       # &b
    add  t3, t3, t0
    lw   t4, 0(t3)
    add  t5, t2, t4
    lw   t6, 12(s0)      # &c
    add  t6, t6, t0
    sw   t5, 0(t6)
"""
    res = pocl_spawn(mc, body, [pa, pb, pc], n, al, label="vecadd",
                     device=device)
    ok = bool(np.array_equal(res.words(pc, n), a + b))
    return res, ok


# ---------------------------------------------------------------------------
# saxpy: y[i] = alpha * x[i] + y[i]  (float)
# ---------------------------------------------------------------------------

def saxpy(mc: MachineConfig, n: int = 512, alpha: float = 2.5, seed: int = 0,
          repeats: int = 1, device: DeviceLike = None
          ) -> Tuple[LaunchResult, bool]:
    """out[i] = alpha*x[i] + y[i].  `repeats` re-walks the same data
    (idempotent — out is a separate buffer), modeling the paper's
    warmed-cache evaluation (§V-D): with data resident in the 4 KB cache,
    the kernel is issue-bound and thread-scaling dominates."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    al = Allocator()
    px, py, po = al.alloc(x), al.alloc(y), al.alloc(n)
    body = f"""
    li   t0, {n}
    rem  t0, s2, t0      # index = gid %% n (repeat passes)
    slli t0, t0, 2
    lw   t1, 8(s0)       # &x
    add  t1, t1, t0
    lw   t2, 0(t1)       # x[i] bits
    lw   t3, 12(s0)      # &y
    add  t3, t3, t0
    lw   t4, 0(t3)       # y[i]
    lw   t5, 4(s0)       # alpha bits
    fmul.s t6, t5, t2
    fadd.s t6, t6, t4
    lw   t3, 16(s0)      # &out
    add  t3, t3, t0
    sw   t6, 0(t3)
"""
    res = pocl_spawn(mc, body, [f32_bits(alpha), px, py, po], n * repeats,
                     al, label="saxpy", device=device)
    want = np.float32(alpha) * x + y
    got = res.floats(po, n)
    ok = bool(np.allclose(got, want, rtol=1e-5, atol=1e-5))
    return res, ok


# ---------------------------------------------------------------------------
# sgemm: C[M,N] = A[M,K] @ B[K,N], one work-item per C element, with an
# smem-tiled variant exercising the global barrier
# ---------------------------------------------------------------------------

def sgemm(mc: MachineConfig, m: int = 16, k: int = 16, n: int = 16,
          seed: int = 0, device: DeviceLike = None
          ) -> Tuple[LaunchResult, bool]:
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    B = (rng.standard_normal((k, n)) * 0.5).astype(np.float32)
    al = Allocator()
    pa, pb, pc = al.alloc(A), al.alloc(B), al.alloc(m * n)
    # args: N-items, M, K, N, &A, &B, &C
    body = f"""
    li   t0, {n}
    div  a0, s2, t0      # row
    rem  a1, s2, t0      # col
    lw   a2, 16(s0)      # &A
    lw   a3, 20(s0)      # &B
    li   a4, {k}
    mul  t1, a0, a4
    slli t1, t1, 2
    add  a2, a2, t1      # &A[row,0]
    slli a5, a1, 2
    add  a3, a3, a5      # &B[0,col]
    li   a5, 0           # acc bits (0.0f)
    li   a6, 0           # kk
_gemm_k:
    bge  a6, a4, _gemm_done
    lw   t2, 0(a2)
    lw   t3, 0(a3)
    fmul.s t4, t2, t3
    fadd.s a5, a5, t4
    addi a2, a2, 4
    li   t5, {4 * n}
    add  a3, a3, t5
    addi a6, a6, 1
    j    _gemm_k
_gemm_done:
    lw   t6, 24(s0)      # &C
    slli t0, s2, 2
    add  t6, t6, t0
    sw   a5, 0(t6)
"""
    res = pocl_spawn(mc, body, [m, k, n, pa, pb, pc], m * n, al,
                     label="sgemm", device=device)
    got = res.floats(pc, m * n).reshape(m, n)
    ok = bool(np.allclose(got, A @ B, rtol=1e-4, atol=1e-4))
    return res, ok


# ---------------------------------------------------------------------------
# bfs: level-synchronous frontier BFS with an in-kernel global-barrier loop
# (Rodinia's BFS relaunches per level; we keep the loop on-device to
# exercise `bar` — same algorithm, §IV-D barriers)
# ---------------------------------------------------------------------------

def make_graph(n_nodes: int, avg_deg: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    adj = []
    starts = np.zeros(n_nodes + 1, np.int32)
    for u in range(n_nodes):
        deg = rng.integers(1, 2 * avg_deg)
        nbrs = rng.integers(0, n_nodes, deg)
        adj.extend(nbrs.tolist())
        starts[u + 1] = len(adj)
    return starts, np.asarray(adj, np.int32)


def bfs_oracle(starts, adj, src, n_nodes):
    dist = np.full(n_nodes, -1, np.int32)
    dist[src] = 0
    frontier = [src]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in adj[starts[u]:starts[u + 1]]:
                if dist[v] < 0:
                    dist[v] = d
                    nxt.append(v)
        frontier = list(dict.fromkeys(nxt))
    return dist


def bfs(mc: MachineConfig, n_nodes: int = 256, avg_deg: int = 4,
        seed: int = 0, device: DeviceLike = None
        ) -> Tuple[LaunchResult, bool]:
    starts, adj = make_graph(n_nodes, avg_deg, seed)
    max_deg = int((starts[1:] - starts[:-1]).max())
    src = 0
    dist = np.full(n_nodes, -1, np.int32)
    dist[src] = 0
    al = Allocator()
    p_starts, p_adj = al.alloc(starts), al.alloc(adj)
    p_dist = al.alloc(dist)
    p_flag = al.alloc(np.zeros(1, np.int32))      # "updated this level" flag
    # Per-lane neighbor counts diverge, so the neighbor walk is a UNIFORM
    # loop over [0, max_deg) with an __if(starts[u]+j < starts[u+1]) guard
    # (classic SIMT flattening).  The level loop uses a 3-barrier protocol:
    # bar(1) level start -> warp0 clears flag -> bar(2) clear visible ->
    # scan (sets flag) -> bar(3) all sets done -> everyone reads flag.
    full = f"""
_start:
    nw   a0
    la   a1, _kmain
    wspawn a0, a1
    j    _kmain
_kmain:
    nt   t0
    tmc  t0
    nt   t2
    nw   t3
    wid  t1
    li   s0, {ARG_BASE}
    lw   s4, 0(s0)       # N nodes
    mul  s3, t3, t2      # stride
    mul  s8, t1, t2      # warp base
    tid  s6
    li   s7, 0           # level
_level:
    li   a0, 1
    nw   a1
    bar  a0, a1
    wid  t1
    bne  t1, zero, _noclear
    lw   a2, 16(s0)
    sw   zero, 0(a2)     # warp0 clears the flag
_noclear:
    li   a0, 2
    nw   a1
    bar  a0, a1
    mv   s1, s8          # reset per-level cursor
_scan:
    bge  s1, s4, _level_done
    add  s2, s1, s6      # node id
    slt  t0, s2, s4
    __if t0
    lw   a2, 12(s0)      # &dist
    slli t1, s2, 2
    add  a2, a2, t1
    lw   a3, 0(a2)       # dist[u]
    xor  t2, a3, s7
    seqz t2, t2          # u in current frontier?
    __if t2
    lw   a4, 4(s0)       # &starts
    add  a4, a4, t1
    lw   a5, 0(a4)       # starts[u]
    lw   a6, 4(a4)       # starts[u+1]
    lw   a7, 8(s0)       # &adj
    li   s9, 0           # j (uniform trip count)
_nbrs:
    li   t3, {max_deg}
    bge  s9, t3, _nbrs_done
    add  t3, a5, s9      # edge index
    slt  t4, t3, a6      # valid edge?
    __if t4
    slli t3, t3, 2
    add  t3, t3, a7
    lw   t4, 0(t3)       # v
    lw   t5, 12(s0)
    slli t6, t4, 2
    add  t5, t5, t6
    lw   t6, 0(t5)       # dist[v]
    addi a0, zero, -1
    xor  t6, t6, a0
    seqz t6, t6          # unvisited?
    __if t6
    addi a0, s7, 1
    sw   a0, 0(t5)       # dist[v] = level+1
    lw   a0, 16(s0)      # &flag
    li   t6, 1
    sw   t6, 0(a0)
    __endif
    __endif
    addi s9, s9, 1
    j    _nbrs
_nbrs_done:
    __endif
    __endif
    add  s1, s1, s3
    j    _scan
_level_done:
    li   a0, 3
    nw   a1
    bar  a0, a1          # all writes of this level are done
    lw   a2, 16(s0)
    lw   a3, 0(a2)       # flag (read before next level's bar(1)+clear)
    addi s7, s7, 1
    bne  a3, zero, _level
    li   a0, 0
    nw   a1
    bar  a0, a1
    halt
"""
    res = raw_spawn(mc, full, al,
                    argwords=[n_nodes, p_starts, p_adj, p_dist, p_flag],
                    label="bfs", device=device)
    want = bfs_oracle(starts, adj, src, n_nodes)
    got = res.words(p_dist, n_nodes)
    ok = bool(np.array_equal(got, want))
    return res, ok


# ---------------------------------------------------------------------------
# gaussian: one Fan2-style elimination step on column kcol
# ---------------------------------------------------------------------------

def gaussian(mc: MachineConfig, n: int = 24, kcol: int = 0, seed: int = 0,
             device: DeviceLike = None) -> Tuple[LaunchResult, bool]:
    """Two kernels like Rodinia's Fan1/Fan2 (a single fused kernel races:
    the factor column is overwritten while other work-items read it)."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + np.eye(n) * n).astype(np.float32)
    al = Allocator()
    pa = al.alloc(A)
    pm = al.alloc(n)                   # multiplier column
    rows, cols = n - kcol - 1, n - kcol
    # Fan1: m[r] = A[r,k] / A[k,k]   (one work-item per row below k)
    fan1 = f"""
    addi a0, s2, {kcol + 1}   # r
    lw   a2, 4(s0)            # &A
    li   t1, {n}
    mul  t3, a0, t1
    addi t3, t3, {kcol}
    slli t3, t3, 2
    add  t3, t3, a2           # &A[r,k]
    li   t4, {kcol * n + kcol}
    slli t4, t4, 2
    add  t4, t4, a2           # &A[k,k]
    lw   a3, 0(t3)
    lw   a4, 0(t4)
    fdiv.s a5, a3, a4
    lw   a6, 8(s0)            # &m
    slli t5, a0, 2
    add  a6, a6, t5
    sw   a5, 0(a6)
"""
    res1 = pocl_spawn(mc, fan1, [pa, pm], rows, al, label="gaussian:fan1",
                      device=device)
    # Fan2: A[r,c] -= m[r] * A[k,c]
    fan2 = f"""
    li   t0, {cols}
    div  a0, s2, t0
    rem  a1, s2, t0
    addi a0, a0, {kcol + 1}   # r
    addi a1, a1, {kcol}       # c
    lw   a2, 4(s0)            # &A
    li   t1, {n}
    mul  t2, a0, t1
    add  t2, t2, a1
    slli t2, t2, 2
    add  t2, t2, a2           # &A[r,c]
    lw   a6, 8(s0)            # &m
    slli t5, a0, 2
    add  a6, a6, t5
    lw   a5, 0(a6)            # m[r]
    li   t5, {kcol}
    mul  t5, t1, t5
    add  t5, t5, a1
    slli t5, t5, 2
    add  t5, t5, a2           # &A[k,c]
    lw   a7, 0(t5)
    fmul.s a7, a5, a7
    lw   t6, 0(t2)
    fsub.s t6, t6, a7
    sw   t6, 0(t2)
"""
    res2 = pocl_spawn(mc, fan2, [pa, pm], rows * cols, al,
                      dmem_init=res1.state.dmem,
                      label="gaussian:fan2", device=device)
    # combined stats: the benchmark reports the sum of both launches
    res2.stats = {k: res1.stats[k] + res2.stats[k] for k in res2.stats}
    want = A.copy()
    factor = want[kcol + 1:, kcol] / want[kcol, kcol]
    want[kcol + 1:, kcol:] -= factor[:, None] * want[kcol, kcol:][None, :]
    got = res2.floats(pa, n * n).reshape(n, n)
    ok = bool(np.allclose(got, want, rtol=2e-4, atol=2e-4))
    return res2, ok


# ---------------------------------------------------------------------------
# nn: squared distances to a query point
# ---------------------------------------------------------------------------

def nn(mc: MachineConfig, n: int = 512, seed: int = 0,
       device: DeviceLike = None) -> Tuple[LaunchResult, bool]:
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal(n).astype(np.float32)
    ys = rng.standard_normal(n).astype(np.float32)
    qx, qy = np.float32(0.3), np.float32(-1.1)
    al = Allocator()
    px, py, pd = al.alloc(xs), al.alloc(ys), al.alloc(n)
    body = """
    slli t0, s2, 2
    lw   t1, 4(s0)
    add  t1, t1, t0
    lw   t2, 0(t1)       # x[i]
    lw   t3, 8(s0)
    add  t3, t3, t0
    lw   t4, 0(t3)       # y[i]
    lw   t5, 16(s0)      # qx
    fsub.s t2, t2, t5
    lw   t5, 20(s0)      # qy
    fsub.s t4, t4, t5
    fmul.s t2, t2, t2
    fmul.s t4, t4, t4
    fadd.s t2, t2, t4
    lw   t6, 12(s0)
    add  t6, t6, t0
    sw   t2, 0(t6)
"""
    res = pocl_spawn(mc, body, [px, py, pd, f32_bits(qx), f32_bits(qy)],
                     n, al, label="nearn", device=device)
    want = (xs - qx) ** 2 + (ys - qy) ** 2
    ok = bool(np.allclose(res.floats(pd, n), want, rtol=1e-5, atol=1e-5))
    return res, ok


# ---------------------------------------------------------------------------
# kmeans: assignment step over K centroids (2-D points)
# ---------------------------------------------------------------------------

def kmeans(mc: MachineConfig, n: int = 256, k: int = 8, seed: int = 0,
           device: DeviceLike = None) -> Tuple[LaunchResult, bool]:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 2)).astype(np.float32)
    cent = rng.standard_normal((k, 2)).astype(np.float32)
    al = Allocator()
    pp, pc, pa = al.alloc(pts), al.alloc(cent), al.alloc(n)
    body = f"""
    lw   a2, 4(s0)        # &pts
    slli t0, s2, 3
    add  a2, a2, t0
    lw   a3, 0(a2)        # px
    lw   a4, 4(a2)        # py
    lw   a5, 8(s0)        # &cent
    li   a6, 0            # best idx
    lui  a7, 0x7f000      # best dist = large float
    li   t5, 0            # j
_km_loop:
    li   t6, {k}
    bge  t5, t6, _km_done
    lw   t1, 0(a5)
    lw   t2, 4(a5)
    fsub.s t1, a3, t1
    fsub.s t2, a4, t2
    fmul.s t1, t1, t1
    fmul.s t2, t2, t2
    fadd.s t1, t1, t2     # dist
    flt.s  t3, t1, a7
    __if t3
    mv   a7, t1
    mv   a6, t5
    __endif
    addi a5, a5, 8
    addi t5, t5, 1
    j    _km_loop
_km_done:
    lw   t4, 12(s0)       # &assign
    slli t0, s2, 2
    add  t4, t4, t0
    sw   a6, 0(t4)
"""
    res = pocl_spawn(mc, body, [pp, pc, pa], n, al, label="kmeans",
                     device=device)
    d = ((pts[:, None, :] - cent[None]) ** 2).sum(-1)
    want = d.argmin(1).astype(np.int32)
    ok = bool(np.array_equal(res.words(pa, n), want))
    return res, ok


BENCHMARKS = {
    "vecadd": vecadd, "saxpy": saxpy, "sgemm": sgemm, "bfs": bfs,
    "gaussian": gaussian, "nn": nn, "kmeans": kmeans,
}
