"""Distributed pieces of the port: gradient compression only (the
sharding, collectives and elastic modules come with a later slice)."""
