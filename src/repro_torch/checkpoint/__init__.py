"""Checkpoints of the port: the JAX package's directory protocol, so a
checkpoint written by either package restores in the other."""
