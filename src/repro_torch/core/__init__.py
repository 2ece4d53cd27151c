"""The paper's system in the port: the Vortex SIMT machine (``simt``)."""
