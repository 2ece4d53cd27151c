"""Hand-written Hopper kernels of the port.

Each kernel has a plain PyTorch version (``ref.py``), a wrapper
(``ops.py``) and a CUDA C++ source under ``repro_torch/csrc/``.  The
wrapper launches the kernel for a CUDA tensor (or raises) and takes the
plain version only for a CPU tensor.  The public entries (``rmsnorm``,
``add_rmsnorm``, ``rmsnorm_split``, ``flash_attention``,
``moe_dispatch``, ``ssd_intra``, ``decode_attention_q8``) go through ``obs.instrument_kernel``: with kernel timing on they count
``kernels.<name>.launches`` and time each call, as the JAX package's
ops do; the wrappers' own ``launches`` counters count kernel launches
whether timing is on or not.

Every kernel on a model's path has a backward: under grad on CUDA the
wrappers run ``torch.autograd.Function``s whose backward is a
hand-written kernel too (RMSNorm, flash attention's FA-2, the MoE
dispatch's gather-sum, SSD's intra-chunk block), counted in each
wrapper's ``bwd_launches``; on the CPU plain autograd runs through the
plain versions.
"""
