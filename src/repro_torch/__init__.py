"""PyTorch port of the JAX package ``repro``, run on an NVIDIA H100.

Serves and trains the ten architectures of the JAX package's configs (on
one card, the nine that fit it) through hand-written Hopper kernels
(``repro_torch.kernels``), which build at first use, never at import;
``repro_torch.core`` is the vNPU core, copied (numpy and scipy only).
Imports ``torch``, numpy and scipy only.
"""
