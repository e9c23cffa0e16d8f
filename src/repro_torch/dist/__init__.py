"""Distributed rules of the port (port of ``repro.dist``): int8 gradient
compression (``collectives``) and the sharding rules of params, optimizer
state, batches and decode caches mapped onto ``torch.distributed`` device
meshes (``sharding``). One card checks them at world size 1."""
