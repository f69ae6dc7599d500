"""The port's half of the disaggregated prefill → decode serving contract.

Only the engine side lives here (``disagg``: export, ship and adopt of paged
KV pages, byte-compatible with ``tony_tpu/serve/disagg.py``'s wire payload,
so a JAX prefill tier can hand pages to a port decode tier and back). The
router side (coordinator, shard ring, fleet router, health, autoscaler,
load generator) is framework-free control plane that ``tony serve`` runs in
its own process; the port does not copy it.
"""
