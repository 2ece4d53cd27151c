"""The paper's system in the port: the Vortex SIMT machine (``simt``),
its divergence combinators (``combinators``) and ``grid_spawn`` over a
mesh's ranks (``spawn``)."""
