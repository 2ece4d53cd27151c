"""The Vortex SIMT machine: ISA, 4-mask scheduler, cycle-level machine
(plain PyTorch loop on the CPU, one CUDA kernel launch on the card) and
the area/power model."""
