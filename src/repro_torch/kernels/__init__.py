"""Hand-written Hopper kernels of the port, one package per TPU kernel it
replaces: ``rmsnorm``, ``flash_attention`` and ``rglru``.  Each
``kernel.py`` holds the wrapper that launches the CUDA kernel
(``csrc/*.cu``, built by ``build.py``) for a CUDA tensor, its plain PyTorch
version used for a CPU tensor, and a launch counter."""
