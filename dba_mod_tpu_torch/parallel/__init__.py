"""Parallelism layer: the clients mesh and multi-process worlds (port of
dba_mod_tpu/parallel/).

Clients are a mesh axis: the stacked per-client round inputs are cut into
contiguous slices, each shard trains its slice on its own device with the
same vmapped client step (one fused update launch per shard per step), and
the per-client results come back to one stack, on the mesh's first device
or through ``torch.distributed``'s all-gather across ranks, before the
server rule runs on the full stack. Multi-process worlds are
``torch.distributed`` process groups (NCCL or gloo), one device per rank.
"""
