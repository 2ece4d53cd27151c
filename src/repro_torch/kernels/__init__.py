"""Hand-written Hopper kernels of the port.

Each kernel has a plain PyTorch version (``ref.py``), a wrapper
(``ops.py``) and a CUDA C++ source under ``repro_torch/csrc/``.  The
wrapper launches the kernel for a CUDA tensor (or raises) and takes the
plain version only for a CPU tensor.  The public entries (``rmsnorm``,
``add_rmsnorm``, ``flash_attention``, ``moe_dispatch``, ``ssd_intra``)
go through ``obs.instrument_kernel``: with kernel timing on they count
``kernels.<name>.launches`` and time each call, as the JAX package's
ops do; the wrappers' own ``launches`` counters count kernel launches
whether timing is on or not.

Kernels with a backward (RMSNorm, flash attention) run as
``torch.autograd.Function``s under grad.  Those without one yet (the MoE
dispatch, SSD) call ``refuse_grad`` first: on CUDA tensors they raise
``NotImplementedError`` under grad instead of handing back an output
that autograd cannot see through.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    `tensors` requires grad: kernel `name` has no backward yet."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise NotImplementedError(
            f"the {name} kernel has no backward yet (ROADMAP Queue 1: MoE "
            "and hybrid training); its output would be cut from the "
            "autograd graph.  Run it under torch.no_grad(), or on the CPU, "
            "where the plain version is differentiable")
