"""Entry points that run the PyTorch port (``tony_tpu_torch``) under the
JAX package's orchestrator.

A package of its own, beside the port and not inside it: it imports the
orchestrator's control plane (``tony_tpu.cli``, ``tony_tpu.serve``), and
importing ``tony_tpu_torch`` must never load that. It imports neither jax
nor torch: the port runs in the replicas it launches.
"""
