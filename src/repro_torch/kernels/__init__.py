"""Hand-written Hopper kernels with their plain PyTorch versions.

The CUDA sources are built at first use (``_build``), never at import.
"""
from . import ops
from .ops import (LAUNCHES, decode_attention, flash_attention, matmul,
                  reset_launches, ssd_scan)
