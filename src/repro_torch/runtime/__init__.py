"""The Vortex runtime in the port: assembler, intrinsics, ``pocl_spawn``."""
