"""Hand-written Hopper kernels of the port.

Each kernel has a plain PyTorch version (``ref.py``), a wrapper
(``ops.py``) and a CUDA C++ source under ``repro_torch/csrc/``.  The
wrapper launches the kernel for a CUDA tensor (or raises) and takes the
plain version only for a CPU tensor.
"""
