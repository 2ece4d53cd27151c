"""The port's elastic fleet machinery against the JAX package: the seven
cases of ``tests/test_elastic.py`` (straggler policy boundaries, pod
masks, rescale planning) on the port's classes, a seeded run of waits
through both packages' ``Fleet`` (masks, skip budgets and the obs
counters equal step by step), the recovery loop with a fleet under a
seeded plan of pod faults and step crashes, and ``plan_rescale``
reading the shapes of the port's meshes (``DeviceMesh.shape``, in axis
order).
``reshard_like`` on a 2x2 gloo mesh is in ``test_torch_distributed``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import elastic as jelastic  # noqa: E402
from repro.obs.registry import Registry as JRegistry  # noqa: E402
from repro_torch.distributed.elastic import (Fleet, PodMasks,  # noqa: E402
                                             RescalePlan, StragglerPolicy,
                                             plan_rescale)
from repro_torch.obs.registry import Registry  # noqa: E402


# ---------------------------------------------------------------------------
# StragglerPolicy.should_skip boundaries
# ---------------------------------------------------------------------------

def test_should_skip_requires_strictly_late():
    p = StragglerPolicy(deadline_s=30.0, max_consecutive_skips=5)
    assert not p.should_skip(29.9, 0)
    assert not p.should_skip(30.0, 0)       # exactly at deadline: not late
    assert p.should_skip(30.0001, 0)


def test_should_skip_exhausts_budget():
    p = StragglerPolicy(deadline_s=1.0, max_consecutive_skips=3)
    assert p.should_skip(2.0, 0)
    assert p.should_skip(2.0, 2)
    assert not p.should_skip(2.0, 3)        # budget spent: no more skips
    assert not p.should_skip(2.0, 4)


def test_rejoin_cursor_is_fleet_step():
    assert StragglerPolicy().rejoin_cursor(123) == 123


# ---------------------------------------------------------------------------
# PodMasks transitions
# ---------------------------------------------------------------------------

def test_pod_masks_transitions():
    m = PodMasks(4)
    assert m.healthy().sum() == 4
    m.mark_straggler(1)
    assert list(m.healthy()) == [True, False, True, True]
    m.rejoin(1)
    assert m.healthy().sum() == 4
    m.fail(2)
    assert list(m.healthy()) == [True, True, False, True]
    m.rejoin(2)                             # rejoin clears stalled only
    assert list(m.healthy()) == [True, True, False, True]
    m.barrier[0] = True
    assert list(m.healthy()) == [False, True, False, True]


def test_fleet_fails_pod_past_skip_budget():
    fleet = Fleet(2, policy=StragglerPolicy(deadline_s=1.0,
                                            max_consecutive_skips=2))
    late = np.asarray([5.0, 0.0])
    for _ in range(2):                      # two skips allowed
        healthy = fleet.note_waits(late)
        assert list(healthy) == [0.0, 1.0]
        assert fleet.masks.active[0]
    fleet.note_waits(late)                  # budget spent -> permanent fail
    assert not fleet.masks.active[0]
    assert fleet.n_healthy() == 1
    # a failed pod never comes back, even if its waits recover
    fleet.note_waits(np.zeros(2))
    assert not fleet.masks.active[0]


def test_fleet_straggler_rejoins_and_resets_budget():
    fleet = Fleet(2, policy=StragglerPolicy(deadline_s=1.0,
                                            max_consecutive_skips=2))
    fleet.note_waits(np.asarray([5.0, 0.0]))
    assert fleet.masks.stalled[0]
    fleet.note_waits(np.zeros(2))
    assert not fleet.masks.stalled[0]
    assert fleet.consecutive[0] == 0        # consecutive counter reset


# ---------------------------------------------------------------------------
# plan_rescale divisibility
# ---------------------------------------------------------------------------

def test_rescale_plan_validates_divisibility():
    plan = RescalePlan(old_shape=(16, 16), new_shape=(2, 16, 16),
                       global_batch=256)
    plan.validate()                         # 256 % 32 == 0
    bad = RescalePlan(old_shape=(16, 16), new_shape=(3, 16, 16),
                      global_batch=256)
    with pytest.raises(ValueError, match="not divisible"):
        bad.validate()
    assert bad.dp_old == 16 and bad.dp_new == 48


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_matches_jax_on_seeded_waits(seed):
    """40 steps of per-pod waits (a third of them late) through both
    fleets: the same healthy mask, skip budgets, masks and counters."""
    rng = np.random.default_rng(seed)
    policy = dict(deadline_s=1.0, max_consecutive_skips=3)
    ours = Fleet(6, policy=StragglerPolicy(**policy), registry=Registry())
    theirs = jelastic.Fleet(6, policy=jelastic.StragglerPolicy(**policy),
                            registry=JRegistry())
    for _ in range(40):
        waits = np.where(rng.random(6) < 0.35, 2.0, 0.1) \
            * rng.random(6) * 2
        np.testing.assert_array_equal(ours.note_waits(waits),
                                      theirs.note_waits(waits))
        for mask in ("active", "stalled", "barrier"):
            np.testing.assert_array_equal(getattr(ours.masks, mask),
                                          getattr(theirs.masks, mask))
        np.testing.assert_array_equal(ours.consecutive, theirs.consecutive)
        assert ours.n_healthy() == theirs.n_healthy()
    for name in ("fleet.pod_skips", "fleet.pod_fails"):
        assert ours.metrics.counter(name).value == \
            theirs.metrics.counter(name).value
    assert ours.metrics.gauge("fleet.pods_healthy").value == \
        theirs.metrics.gauge("fleet.pods_healthy").value


def test_plan_rescale_reads_mesh_shapes_in_axis_order():
    """A world of one gloo rank: the port's 1x1 test mesh and a (pod,
    data, model) mesh of one rank each, against JAX's plan on the same
    shapes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as mesh_mod

    class JMesh:                            # what JAX's plan reads
        def __init__(self, shape):
            self.shape = dict(zip(("pod", "data", "model")[-len(shape):],
                                  shape))
    _, started = mesh_mod.init_world("cpu")
    try:
        old = mesh_mod.make_test_mesh(1, 1)
        new = DeviceMesh("cpu", torch.zeros((1, 1, 1), dtype=torch.int64),
                         mesh_dim_names=("pod", "data", "model"))
        plan = plan_rescale(old, new, global_batch=4)
        want = jelastic.plan_rescale(JMesh((1, 1)), JMesh((1, 1, 1)), 4)
        assert (plan.old_shape, plan.new_shape, plan.dp_old, plan.dp_new) \
            == (want.old_shape, want.new_shape, want.dp_old, want.dp_new) \
            == ((1, 1), (1, 1, 1), 1, 1)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("seed", [3, 4])
def test_recovery_loop_with_a_fleet_matches_jax(seed):
    """``train_with_recovery(fleet=...)`` against the JAX loop under one
    seeded plan of pod stalls, pod failures and step crashes: each
    step's pod-split batch and healthy mask, the restarts and the
    fleet's masks and counters.  The step is a recorder in both (the
    fleet step's arithmetic is ``test_torch_training``'s)."""
    from repro.configs import reduced_config as jax_reduced_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.data.pipeline import Loader as JLoader
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.faults import plan as jplan
    from repro.training.resilient import train_with_recovery as jtrain
    from repro_torch.configs import ShapeConfig, reduced_config
    from repro_torch.data.pipeline import Loader, SyntheticLM
    from repro_torch.faults import plan
    from repro_torch.training.resilient import train_with_recovery
    rates = {("pod", "pod_stall"): 0.3, ("pod", "pod_fail"): 0.05,
             ("train.step", "exception"): 0.15}
    arch, n_pods, steps = "h2o-danube-1.8b", 4, 12
    policy = dict(deadline_s=1.0, max_consecutive_skips=2)

    def run(pkg):
        if pkg == "jax":
            p = jplan.FaultPlan.generate(seed, horizon=64, rates=rates,
                                         n_pods=n_pods)
            inj, train = jplan.FaultInjector(p), jtrain
            fleet = jelastic.Fleet(
                n_pods, policy=jelastic.StragglerPolicy(**policy),
                registry=JRegistry())
            loader = JLoader(JSyntheticLM(
                jax_reduced_config(arch), JShapeConfig("t", 8, 8, "train")))
        else:
            p = plan.FaultPlan.generate(seed, horizon=64, rates=rates,
                                        n_pods=n_pods)
            inj, train = plan.FaultInjector(p), train_with_recovery
            fleet = Fleet(n_pods, policy=StragglerPolicy(**policy),
                          registry=Registry())
            loader = Loader(SyntheticLM(
                reduced_config(arch), ShapeConfig("t", 8, 8, "train")),
                device="cpu")
        seen = []

        def step_fn(state, pod_batch, healthy):
            seen.append((np.asarray(pod_batch["tokens"]).copy(),
                         np.asarray(healthy).copy()))
            return state + 1, {"loss": 0.0}
        state, restarts = train(0, step_fn, loader, total_steps=steps,
                                injector=inj, max_restarts=20,
                                backoff_base_s=0.0, fleet=fleet)
        return state, restarts, seen, fleet
    ours, theirs = run("torch"), run("jax")
    assert ours[:2] == theirs[:2] and ours[0] == steps
    assert len(ours[2]) == len(theirs[2]) == steps
    for (tok, h), (jtok, jh) in zip(ours[2], theirs[2]):
        assert tok.shape[:2] == (n_pods, 2)
        np.testing.assert_array_equal(tok, jtok)
        np.testing.assert_array_equal(h, jh)
    for mask in ("active", "stalled", "barrier"):
        np.testing.assert_array_equal(getattr(ours[3].masks, mask),
                                      getattr(theirs[3].masks, mask))
    for name in ("fleet.pod_skips", "fleet.pod_fails"):
        assert ours[3].metrics.counter(name).value == \
            theirs[3].metrics.counter(name).value
    assert ours[1] > 0 and ours[3].metrics.counter(
        "fleet.pod_skips").value > 0
