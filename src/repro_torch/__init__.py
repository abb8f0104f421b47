"""PyTorch / CUDA port of the MiCS reproduction, for NVIDIA Hopper (H100).

Mirrors ``src/repro/`` module for module.  This package imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of the JAX package: it keeps
its own copies of what it needs.  Entry points take an explicit ``device``
and default to ``"cuda"``; without a card they raise unless the caller asks
for ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
