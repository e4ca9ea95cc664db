"""PyTorch port of the JAX package ``repro``, run on an NVIDIA H100.

Serves the dense decoder LMs through hand-written Hopper kernels
(``repro_torch.kernels``), which build at first use, never at import.
Imports ``torch`` and numpy only.
"""
