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
"""
