"""Distributed pieces of the port: the logical-axis sharding rules
(``sharding``), collectives over a mesh axis (``collectives``), gradient
compression (``compression``) and elastic rescaling (``elastic``)."""
