"""Observability of the port's training child: own copies of the subset of
``tony_tpu/obs`` it writes (the metrics registry, spans, JSON log records and
the introspection file contract), in the file formats the control plane
reads, so a port job shows in ``tony top``, ``tony goodput``, ``tony trace``,
``tony logs`` and the portal as a JAX job does."""
