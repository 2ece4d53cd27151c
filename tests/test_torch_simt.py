"""The port's SIMT machine and Rodinia runtime against the JAX package's.

CPU parity: the same assembled programs and data-memory images go
through the JAX machine (``repro.core.simt.machine.run``) and the port's
plain PyTorch loop (``repro_torch.core.simt.machine.run_plain``, which
``run`` takes for CPU tensors); every ``State`` field and every counter
must be equal, exactly.  Programs: those of ``test_simt_machine.py``,
the ALUs on edge values, aliasing and sub-word stores, IPDOM stacks past
their depth, every Rodinia bench at ``test_rodinia.py``'s sizes on two
configurations, and the spawn functions with the launch log.

On a card (``gpu`` marker, skipped without one; no JAX needed):
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_simt.py``
holds the CUDA kernel (``machine.run`` on CUDA tensors) to the plain
loop on CUDA tensors, exactly.
"""
import json
import struct
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.simt import machine, power, scheduler  # noqa: E402
from repro_torch.core.simt.machine import MachineConfig  # noqa: E402
from repro_torch.kernels.simt_machine import ops as simt_ops  # noqa: E402
from repro_torch.runtime import spawn  # noqa: E402
from repro_torch.runtime.asm import assemble  # noqa: E402
from repro_torch.runtime.kernels_src import edge_cases, rodinia  # noqa: E402

CPU = "cpu"
PAD = 256       # unit programs are padded to one length: one JAX compile
MC = dict(warps=4, threads=4, max_cycles=100_000)
FIELDS = [f for f in machine.State._fields if f != "stats"]
CASES = {  # tests/test_rodinia.py's sizes
    "vecadd": dict(n=256),
    "saxpy": dict(n=256),
    "sgemm": dict(m=8, k=8, n=8),
    "bfs": dict(n_nodes=64, avg_deg=3),
    "gaussian": dict(n=12),
    "nn": dict(n=256),
    "kmeans": dict(n=64, k=4),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's machine, scheduler, runtime and ALUs."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.core.simt import machine as jm
    from repro.core.simt import power as jpower
    from repro.core.simt import scheduler as jsched
    from repro.runtime import spawn as jspawn
    from repro.runtime.kernels_src import rodinia as jrodinia
    return types.SimpleNamespace(
        jnp=jnp, machine=jm, scheduler=jsched, spawn=jspawn,
        rodinia=jrodinia, power=jpower,
        alu_int=jax.jit(jm._alu_int), alu_m=jax.jit(jm._alu_m),
        alu_fp=jax.jit(jm._alu_fp))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _padded(src: str) -> np.ndarray:
    words = assemble(src)
    assert len(words) <= PAD
    out = np.zeros(PAD, np.uint32)
    out[:len(words)] = words
    return out


def assert_same_state(want, got, want_stats):
    """Every field of State `got` (the port's) equal to `want`'s (the
    JAX machine's or the port's), and its counters to `want_stats`."""
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f).cpu().numpy()
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert w.shape == g.shape, (f, w.shape, g.shape)
        assert np.array_equal(w.astype(np.int64), g.astype(np.int64)), f
    assert machine.stats_dict(got) == want_stats


# ---------------------------------------------------------------------------
# unit programs (tests/test_simt_machine.py's) and edge cases
# ---------------------------------------------------------------------------

def _bits(f):
    return struct.unpack("<i", struct.pack("<f", np.float32(f)))[0]


ALU_OPS = [("add", 7, -3), ("sub", 7, 9), ("and", 0b1100, 0b1010),
           ("or", 0b1100, 0b1010), ("xor", 0b1100, 0b1010), ("sll", 3, 4),
           ("srl", -8, 1), ("sra", -8, 1), ("slt", -5, 3), ("sltu", -5, 3),
           ("mul", -7, 6), ("div", -7, 2), ("rem", -7, 2), ("divu", 7, 2),
           ("remu", 7, 2), ("mulh", -123456789, 987654321)]

UNIT = {f"alu_{op}": f"""
    li t0, {a}
    li t1, {b}
    {op} t2, t0, t1
    li t3, 0x200
    sw t2, 0(t3)
    halt
""" for op, a, b in ALU_OPS}
UNIT.update({
    "div_by_zero": """
    li t0, 17
    li t1, 0
    div t2, t0, t1
    rem t3, t0, t1
    li t4, 0x200
    sw t2, 0(t4)
    sw t3, 4(t4)
    halt
""",
    "float_zfinx": f"""
    li t0, {_bits(2.5)}
    li t1, {_bits(-0.75)}
    fadd.s t2, t0, t1
    fmul.s t3, t0, t1
    fdiv.s t4, t0, t1
    flt.s  t5, t1, t0
    li a0, 0x200
    sw t2, 0(a0)
    sw t3, 4(a0)
    sw t4, 8(a0)
    sw t5, 12(a0)
    halt
""",
    "tmc": """
    nt t0
    tmc t0
    tid t1
    slli t2, t1, 2
    li t3, 0x200
    add t2, t2, t3
    li t4, 1
    sw t4, 0(t2)
    li t5, 2
    tmc t5
    li t4, 9
    sw t4, 0(t2)
    halt
""",
    "wspawn": """
    nw a0
    la a1, _wmain
    wspawn a0, a1
    j _wmain
_wmain:
    nt t0
    tmc t0
    wid t1
    slli t2, t1, 2
    li t3, 0x200
    add t2, t2, t3
    addi t4, t1, 100
    sw t4, 0(t2)
    halt
""",
    "split_join_nested": """
    nt t0
    tmc t0
    tid t1
    li t6, 0
    slti t2, t1, 2
    __if t2
    addi t6, t6, 1
    slti t3, t1, 1
    __if t3
    addi t6, t6, 10
    __endif
    __else
    addi t6, t6, 100
    __endif
    slli t2, t1, 2
    li t3, 0x200
    add t2, t2, t3
    sw t6, 0(t2)
    halt
""",
    "split_uniform_true": """
    nt t0
    tmc t0
    li t1, 1
    li t6, 0
    __if t1
    addi t6, t6, 5
    __else
    addi t6, t6, 777
    __endif
    tid t2
    slli t2, t2, 2
    li t3, 0x200
    add t2, t2, t3
    sw t6, 0(t2)
    halt
""",
    "split_uniform_false": """
    nt t0
    tmc t0
    li t1, 0
    li t6, 0
    __if t1
    addi t6, t6, 777
    __else
    addi t6, t6, 3
    __endif
    tid t2
    slli t2, t2, 2
    li t3, 0x200
    add t2, t2, t3
    sw t6, 0(t2)
    halt
""",
    "barrier": """
    nw a0
    la a1, _wmain
    wspawn a0, a1
    j _wmain
_wmain:
    nt t0
    tmc t0
    wid t1
    slli t2, t1, 3
_spin:
    addi t2, t2, -1
    bge t2, zero, _spin
    li a0, 1
    nw a1
    bar a0, a1
    wid t1
    slli t2, t1, 2
    li t3, 0x200
    add t2, t2, t3
    li t4, 55
    sw t4, 0(t2)
    rdcycle t5
    sw t5, 64(t2)
    halt
""",
    "alias_stores": edge_cases.ALIAS_STORES,
})
EDGE_SRC, EDGE_IMAGE, _ = edge_cases.alu_edges()
# (name, program, dmem image, config overrides)
PROGRAMS = [(name, src, None, {}) for name, src in UNIT.items()] + [
    ("alu_edges", EDGE_SRC, EDGE_IMAGE, dict(miss_latency=1)),
    ("ipdom_overflow", edge_cases.IPDOM_OVERFLOW, None,
     dict(ipdom_depth=2, max_cycles=3000))]


@pytest.mark.parametrize("name,src,image,over", PROGRAMS,
                         ids=[p[0] for p in PROGRAMS])
def test_program_matches_jax(jx, name, src, image, over):
    kw = {**MC, **over}
    prog = _padded(src)
    want = jx.machine.run(jx.machine.MachineConfig(**kw), prog,
                          dmem_image=image)
    got = machine.run(MachineConfig(**kw), prog, dmem_image=image,
                      device=CPU)
    assert_same_state(want, got, jx.machine.stats_dict(want))
    assert int(got.cycle) > 0


def test_unit_program_results():
    """The JAX tests' own expectations hold for the port."""
    mc = MachineConfig(**MC)

    def words(name, n):
        st = machine.run(mc, assemble(UNIT[name]), device=CPU)
        return machine.read_words(st, 0x200, n).tolist(), st

    assert words("tmc", 4)[0] == [9, 9, 1, 1]
    assert words("wspawn", 4)[0] == [100, 101, 102, 103]
    got, st = words("split_join_nested", 4)
    assert got == [11, 1, 100, 100]
    assert machine.stats_dict(st)["divergent_splits"] == 2
    assert words("split_uniform_true", 4)[0] == [5, 5, 5, 5]
    assert words("split_uniform_false", 4)[0] == [3, 3, 3, 3]
    got, st = words("barrier", 4)
    assert got == [55] * 4 and machine.stats_dict(st)["barrier_waits"] == 3
    assert words("div_by_zero", 2)[0] == [-1, 17]


def test_alias_store_results():
    """Last-wins in lane order: masked-off aliasing lanes undo stores,
    only the highest lane's bytes survive, lane 3's smem store wins and
    its dmem write-back undoes lane 0's store."""
    st = machine.run(MachineConfig(**MC), assemble(edge_cases.ALIAS_STORES),
                     device=CPU)
    w = lambda a, n=1: machine.read_words(st, a, n).tolist()  # noqa: E731
    assert w(0x400, 2) == [0, 0]
    assert w(0x500) == [np.int32(np.uint32(0xF4000000))]
    assert w(0x600) == [np.int32(np.uint32(0xFB000000))]
    assert w(0) == [0] and int(st.smem[0]) == 10


@pytest.mark.parametrize("scenario", ["a", "b", "c", "idle"])
def test_scheduler_fig6(jx, scenario):
    """Fig 6's scenarios on bool tensors, against the JAX scheduler."""
    masks = {  # active, stalled, steps
        "a": ([1, 1, 0, 0], [0, 0, 0, 0], 3),
        "b": ([1, 1, 0, 0], [1, 0, 0, 0], 2),
        "c": ([1, 0, 1, 1], [0, 0, 0, 0], 3),
        "idle": ([1, 0, 0, 0], [1, 0, 0, 0], 1)}
    active, stalled, steps = masks[scenario]
    want = {"a": [0, 1, 0], "b": [1, 1], "c": [0, 2, 3], "idle": [4]}

    def walk(m, mk):
        vis, order = mk([0] * 4), []
        for _ in range(steps):
            w, vis = m.step_masks(vis, mk(active), mk(stalled), mk([0] * 4))
            order.append(int(w))
        return order

    got = walk(scheduler, lambda b: torch.tensor(b, dtype=torch.bool))
    assert got == want[scenario]
    assert got == walk(jx.scheduler,
                       lambda b: jx.jnp.asarray(b, dtype=bool))


# ---------------------------------------------------------------------------
# the ALUs on edge inputs
# ---------------------------------------------------------------------------

EDGE = np.array(
    [0, 1, 0x80000001, 0x007FFFFF, 0x00800000, 0x80000000, 0x3F7FFFFF,
     0x3F800000, 0xBF800000, 0x00FFFFFF, 0x40000000, 0x7FC00000,
     0xFFC00000, 0x7FC12345, 0x7F812345, 0xFF812345, 0x7F800000,
     0xFF800000, 0x4F32D05E, 0xCF32D05E, 0x4F000000, 0xCF000000,
     0xBF000000, 0x7FFFFFFF, 0xFFFFFFFF, 17, 0xFFFFFFF9, 0x0DA24260,
     0x501502F9], np.uint32).view(np.int32)
A_EDGE = np.repeat(EDGE, len(EDGE))
B_EDGE = np.tile(EDGE, len(EDGE))
FP_OPS = [(0x00, 0), (0x04, 0), (0x08, 0), (0x0C, 0), (0x2C, 0), (0x14, 0),
          (0x14, 1), (0x14, 2), (0x50, 0), (0x50, 1), (0x50, 2), (0x50, 3),
          (0x60, 0), (0x68, 0), (0x7F, 0)]


@pytest.mark.parametrize("f7,f3", FP_OPS)
def test_alu_fp_edges_match_jax(jx, f7, f3):
    """Denormals, +-0, NaN payloads and signs, inf, +-2^31 and tiny
    quotients/products, every pair, bit-exact."""
    want = np.asarray(jx.alu_fp(jx.jnp.int32(f7), jx.jnp.int32(f3),
                                A_EDGE, B_EDGE))
    got = machine._alu_fp(f7, f3, torch.from_numpy(A_EDGE),
                         torch.from_numpy(B_EDGE)).numpy()
    bad = np.nonzero(want != got)[0]
    assert bad.size == 0, [(hex(A_EDGE[i] & 0xFFFFFFFF),
                            hex(B_EDGE[i] & 0xFFFFFFFF),
                            hex(want[i] & 0xFFFFFFFF),
                            hex(got[i] & 0xFFFFFFFF)) for i in bad[:8]]


@pytest.mark.parametrize("group", ["int", "int_alt", "m"])
def test_alu_int_edges_match_jax(jx, group):
    """INT_MIN / -1, division by zero, sign mixes for mulh*, shifts by
    amounts past 31, every pair, every funct3."""
    a, b = torch.from_numpy(A_EDGE), torch.from_numpy(B_EDGE)
    for f3 in range(8):
        if group == "m":
            want = jx.alu_m(jx.jnp.int32(f3), A_EDGE, B_EDGE)
            got = machine._alu_m(f3, a, b)
        else:
            alt = group == "int_alt"
            want = jx.alu_int(jx.jnp.int32(f3), jx.jnp.bool_(alt), A_EDGE,
                              B_EDGE)
            got = machine._alu_int(f3, alt, a, b)
        assert np.array_equal(np.asarray(want), got.numpy()), (group, f3)


# ---------------------------------------------------------------------------
# the runtime: Rodinia benches, spawn functions, launch log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wt", [(4, 4), (2, 8)], ids=["4w4t", "2w8t"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rodinia_matches_jax(jx, name, wt):
    w, t = wt
    jres, jok = jx.rodinia.BENCHMARKS[name](
        jx.machine.MachineConfig(warps=w, threads=t, max_cycles=3_000_000),
        **CASES[name])
    res, ok = rodinia.BENCHMARKS[name](
        MachineConfig(warps=w, threads=t, max_cycles=3_000_000),
        device=CPU, **CASES[name])
    assert ok and jok
    assert res.stats == jres.stats
    assert_same_state(jres.state, res.state,
                      jx.machine.stats_dict(jres.state))


def test_spawn_and_launch_log_match_jax(jx):
    """pocl_spawn (gaussian's two launches) and raw_spawn (bfs) with the
    launch log on: results, stats and per-kernel aggregates equal."""
    logs = (jx.machine.launch_log, machine.launch_log)
    for log in logs:
        log.clear()
        log.enable()
    try:
        # test_rodinia_matches_jax's 4w4t config: the JAX runs are compiled
        jmc = jx.machine.MachineConfig(warps=4, threads=4,
                                       max_cycles=3_000_000)
        mc = MachineConfig(warps=4, threads=4, max_cycles=3_000_000)
        for name in ("gaussian", "bfs"):
            jres, _ = jx.rodinia.BENCHMARKS[name](jmc, **CASES[name])
            res, _ = rodinia.BENCHMARKS[name](mc, device=CPU, **CASES[name])
            assert res.stats == jres.stats
            assert np.array_equal(res.words(0x1000, 256),
                                  jres.words(0x1000, 256))
            assert np.array_equal(res.floats(0x1000, 64),
                                  jres.floats(0x1000, 64), equal_nan=True)
        strip = lambda per: {k: {s: v for s, v in agg.items()  # noqa: E731
                                 if s != "wall_s"}
                             for k, agg in per.items()}
        per = logs[1].per_kernel()
        assert set(per) == {"gaussian:fan1", "gaussian:fan2", "bfs"}
        assert strip(per) == strip(logs[0].per_kernel())
        reps = logs[1].reports(mc)
        assert reps["gaussian:fan1"].ipc != reps["gaussian:fan2"].ipc
    finally:
        for log in logs:
            log.disable()
            log.clear()
    assert spawn.f32_bits(2.5) == jx.spawn.f32_bits(2.5)


def test_spawn_raises_past_max_cycles():
    """Both spawn functions keep the JAX runtime's RuntimeError."""
    mc = MachineConfig(max_cycles=50)
    with pytest.raises(RuntimeError, match="max_cycles"):
        spawn.pocl_spawn(mc, "    add t0, t0, t0\n", [], 64, device=CPU)
    with pytest.raises(RuntimeError, match="max_cycles"):
        spawn.raw_spawn(mc, "_l:\n    j _l\n", device=CPU)


def test_telemetry_matches_jax(jx):
    """Trace span, flight event and PerfReport of a labelled launch."""
    src = UNIT["barrier"]
    obs.tracer.clear()
    obs.flight.clear()
    obs.enable_tracing()
    obs.flight.enable()
    try:
        st = machine.run(MachineConfig(**MC), assemble(src), label="bar",
                         device=CPU)
    finally:
        obs.disable_tracing()
        obs.flight.disable()
    names = [e["name"] for e in obs.tracer.drain() if e.get("ph") == "X"]
    events = [e for e in obs.flight.snapshot() if e["kind"] == "simt.launch"]
    obs.flight.clear()
    assert names == ["simt:launch:bar"]
    assert events and events[0]["label"] == "bar"
    assert events[0]["cycles"] == int(st.cycle)
    jst = jx.machine.run(jx.machine.MachineConfig(**MC), assemble(src))
    want = jx.machine.perf_report(jst, jx.machine.MachineConfig(**MC))
    got = machine.perf_report(st, MachineConfig(**MC))
    assert got.as_dict() == want.as_dict()


def test_power_model_matches_jax(jx):
    for w, t in [(1, 1), (2, 2), (8, 4), (2, 32), (32, 2), (32, 32)]:
        for fn in ("area", "power_mw", "area_normalized",
                   "power_normalized", "cell_count_normalized"):
            assert getattr(power, fn)(w, t) == getattr(jx.power, fn)(w, t)
        assert (power.power_efficiency(1234, w, t).perf_per_watt
                == jx.power.power_efficiency(1234, w, t).perf_per_watt)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda():
    """Without a card and without device='cpu' the entry points raise;
    the CUDA wrapper takes at most 32 threads a warp."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    mc = MachineConfig(warps=2, threads=2)
    prog = assemble("    halt\n")
    for call in (lambda: machine.run(mc, prog),
                 lambda: machine.init_state(mc),
                 lambda: spawn.raw_spawn(mc, "    halt\n"),
                 lambda: spawn.pocl_spawn(mc, "", [], 4),
                 lambda: rodinia.vecadd(mc, n=8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    wide = MachineConfig(warps=2, threads=33)
    with pytest.raises(ValueError, match="threads <= 32"):
        simt_ops.simt_machine(wide, torch.zeros(1, dtype=torch.int32),
                              machine.init_state(wide, device=CPU))


def test_cpu_run_counts_no_kernel_launch():
    before = simt_ops.launches
    machine.run(MachineConfig(**MC), assemble(UNIT["tmc"]), device=CPU)
    assert simt_ops.launches == before


def test_demo_runs_on_cpu(tmp_path):
    """``python -m repro_torch.obs.demo --device cpu``: per-label
    PerfReports, the reduced serving session with the HTTP plane, a
    validated flight dump and a Chrome trace."""
    from repro_torch.obs import demo
    out = tmp_path / "demo.trace.json"
    try:
        assert demo.main(["--device", "cpu", "--out", str(out)]) == 0
    finally:
        obs.disable_tracing()
        obs.disable_kernel_timing()
        obs.flight.disable()
        obs.flight.clear()
        obs.tracer.clear()
        obs.metrics.reset()
        machine.launch_log.disable()
        machine.launch_log.clear()
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]
             if e.get("ph") == "X"}
    assert "simt:launch:saxpy" in names and len(names) >= 3


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain loop on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("wt", [(4, 4), (2, 8), (8, 32), (40, 4)],
                         ids=["4w4t", "2w8t", "8w32t", "40w4t"])
@pytest.mark.parametrize("name,src,image,over", PROGRAMS,
                         ids=[p[0] for p in PROGRAMS])
def test_kernel_matches_plain(cuda, name, src, image, over, wt):
    mc = MachineConfig(**{**MC, **over, "warps": wt[0], "threads": wt[1]})
    prog = assemble(src)
    before = simt_ops.launches
    got = machine.run(mc, prog, dmem_image=image, device=cuda)
    torch.cuda.synchronize()
    assert simt_ops.launches == before + 1
    want = machine.run_plain(mc, prog, dmem_image=image, device=cuda)
    assert_same_state(want, got, machine.stats_dict(want))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vecadd", "gaussian", "bfs"])
def test_kernel_matches_plain_rodinia(cuda, monkeypatch, name):
    """Each launch of a bench (kernel) replayed through the plain loop on
    the card from the same program and image."""
    launches = []
    real = machine.run

    def recording(mc, program, dmem_image=None, **kw):
        out = real(mc, program, dmem_image=dmem_image, **kw)
        launches.append((mc, program, dmem_image, out))
        return out

    monkeypatch.setattr(machine, "run", recording)
    mc = MachineConfig(warps=4, threads=4, max_cycles=3_000_000)
    res, ok = rodinia.BENCHMARKS[name](mc, device=cuda, **CASES[name])
    assert ok and launches
    for mc_, program, image, out in launches:
        want = machine.run_plain(mc_, program, dmem_image=image,
                                 device=cuda)
        assert_same_state(want, out, machine.stats_dict(want))


@pytest.mark.gpu
def test_kernel_continues_a_state(cuda):
    """A launch from a mid-run state (max_cycles cut) continues exactly
    as the plain loop does."""
    mc = MachineConfig(warps=4, threads=4, max_cycles=40)
    prog = assemble(UNIT["barrier"])
    half = machine.run(mc, prog, device=cuda)
    full = MachineConfig(warps=4, threads=4, max_cycles=100_000)
    got = machine.run(full, prog, state=half)
    want = machine.run_plain(full, prog, state=half)
    assert_same_state(want, got, machine.stats_dict(want))
