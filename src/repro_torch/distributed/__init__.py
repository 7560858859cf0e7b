"""Multi-card layout of the port: logical-axis sharding rules and the
collectives of tensor-parallel serving."""
