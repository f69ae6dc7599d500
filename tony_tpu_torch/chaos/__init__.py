"""Seeded fault injection in the training child: own copy of the subset of
``tony_tpu/chaos`` the child applies (the ``ckpt-corrupt`` fault, with the
once-per-job latch shared with the control plane's processes)."""
