"""PyTorch/CUDA port of tony-tpu's serving path, for NVIDIA Hopper (H100).

Mirrors the layout of ``tony_tpu`` (``ops/``, ``models/``) so each module's
JAX counterpart is found under the same name. The port imports ``torch``
and never ``jax`` or anything of ``tony_tpu``: what it needs from the JAX
package's framework-free modules it keeps as its own copy.

Every entry point runs on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); without a GPU and without that
request it raises (``tony_tpu_torch.device.resolve_device``).
"""
