"""Kernels written for the Vortex runtime (the Rodinia subset)."""
