"""Seeded, deterministic fault injection (see plan.py for the model): a
copy of ``repro.faults``, which imports no JAX.

    plan = FaultPlan.generate(seed=7, horizon=32,
                              rates={("serving.logits", "nan_logits"): 0.2})
    inj = FaultInjector(plan)
    eng = Engine(cfg, params, faults=inj, ...)

Same seed -> identical schedule; every fired fault is counted in the
injector's registry.  All hooks are `None`-guarded no-ops when no
injector is attached.
"""
from repro_torch.faults.chaos import (corrupt_checkpoint, serving_plan,
                                      training_plan)
from repro_torch.faults.plan import (DEFAULT_ARGS, Fault, FaultInjector,
                                     FaultPlan, TransientFault)

__all__ = ["Fault", "FaultPlan", "FaultInjector", "TransientFault",
           "DEFAULT_ARGS", "corrupt_checkpoint", "serving_plan",
           "training_plan"]
